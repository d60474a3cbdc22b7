"""The port's PoseTrainer against the JAX package's, fp32 on the CPU at
64x96 b2 (16x24 heatmaps) with the full-width HRNet-W18-small: the history
of two epochs of two steps, a bit-equal resume that carries the learning
rate in the checkpoint, and min-mode early stopping on the validation loss.
"""

import itertools

import numpy as np
import torch

import jax

from mtg_card_image_segmentation_tpu import config as jax_config

from mtg_card_image_segmentation_tpu_torch import config as port_config
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
from mtg_card_image_segmentation_tpu_torch.training.pose_trainer import (
    PoseTrainer,
    ReduceLROnPlateau,
)
from pose_common import B, HM, H, W, batch, leaves, two_pass_variance

torch.set_num_threads(2)

OVER = {
    "pose": {"input_height": H, "input_width": W, "heatmap_height": HM[0],
             "heatmap_width": HM[1], "compute_dtype": "float32"},
    "data": {"batch_size": B},
    "train": {"num_epochs": 2, "steps_per_epoch": 2, "save_every_epochs": 1,
              "log_every_steps": 1},
}
TRAIN = [batch(20 + i) for i in range(4)]
VAL = [batch(30 + i) for i in range(2)]
RECAL = [batch(40)[0]]


def _cfg(pkg, tmp_path, sub):
    return pkg.pose_default_config().override(OVER).override(
        {"train": {"checkpoint_dir": str(tmp_path / sub / "ckpts"),
                   "log_dir": str(tmp_path / sub / "logs")}})


def _port_train(trainer, start=0):
    t = [tuple(torch.from_numpy(a) for a in b) for b in TRAIN]
    v = [tuple(torch.from_numpy(a) for a in b) for b in VAL]
    r = [torch.from_numpy(x) for x in RECAL]
    return trainer.train(iter(t[start:]), lambda: v, lambda: r)


def test_pose_trainer_history_matches_the_jax_trainer(tmp_path):
    """Two epochs of two steps in both packages' trainers from the JAX
    trainer's initial weights and the same batches (AdamW, wd 1e-4, fp32,
    validation after recalibration every epoch; the JAX model with Flax's
    two-pass variance, see pose_common.py): the same history keys and
    values (losses to 1e-4 relative, the corner metrics to 1e-3 px and
    1e-3 %), the checkpoints and the rate.

    The rate is 1e-6, not the config's 1e-3: AdamW's first updates are
    +-lr for every entry whose gradient is above eps, so an entry whose
    gradient sign lies inside the two packages' fp32 rounding moves by
    2 lr. At 1e-3 that parts the histories by 0.4 % of the loss in two
    steps (measured); at 1e-6 by 6e-6. AdamW's update itself is held to
    optax's in test_torch_train_parts.py.

    Since the parameters barely move at 1e-6, the updates are held apart
    from the losses: the optimizer's hyperparameters equal optax's (b1,
    b2, eps, weight decay, rate), and per tensor the AdamW moments ``mu``
    and ``nu`` after the four steps and the change of the parameters over
    them stay within a few percent of the JAX trainer's in L2 norm
    (measured: mu 0.65 %, nu 0.54 %, the change 3.2 % at worst, where a
    skipped update, a lost step or another b1 misses by its whole
    size)."""
    from mtg_card_image_segmentation_tpu.parallel import make_mesh
    from mtg_card_image_segmentation_tpu.training.pose_trainer import PoseTrainer as JaxTrainer

    slow = {"optimizer": {"learning_rate": 1e-6}}
    jt = JaxTrainer(_cfg(jax_config, tmp_path, "jax").override(slow),
                    mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    init = [jax.tree.map(np.asarray, t) for t in (jt.state.params, jt.state.batch_stats)]
    with two_pass_variance():
        jhist = jt.train(iter(TRAIN), lambda: VAL, lambda: RECAL)
    ours = PoseTrainer(_cfg(port_config, tmp_path, "port").override(slow), device="cpu")
    ours.state.load_variables(*init)
    hist = _port_train(ours)
    assert set(hist) == set(jhist) and len(hist["train_loss"]) == 2
    for k in jhist:
        rtol = 1e-4 if k.endswith("loss") else 0
        np.testing.assert_allclose(hist[k], jhist[k], rtol=rtol, atol=1e-3, err_msg=k)
    assert ours.learning_rate == float(jt.state.opt_state.hyperparams["learning_rate"])
    want = {k: float(v) for k, v in jt.state.opt_state.hyperparams.items()}
    group = ours.state.optimizer.param_groups[0]
    got = {"learning_rate": group["lr"], "b1": group["betas"][0], "b2": group["betas"][1],
           "eps": group["eps"], "weight_decay": group["weight_decay"], "eps_root": 0.0}
    assert set(got) == set(want)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-6)

    def rel_norm(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)

    adam = jt.state.opt_state.inner_state[0]
    moments = ours.state.opt_state()
    p0, pj = leaves(init[0]), leaves(jax.tree.map(np.asarray, jt.state.params))
    pp = leaves(ours.state.variables()["params"])
    for slot, tol in (("mu", 2e-2), ("nu", 2e-2)):
        mj = leaves(jax.tree.map(np.asarray, getattr(adam, slot)))
        mp = leaves(moments[slot])
        assert set(mp) == set(mj) == set(p0)
        worst = max(mj, key=lambda k: rel_norm(mp[k], mj[k]))
        assert rel_norm(mp[worst], mj[worst]) <= tol, (slot, worst, rel_norm(mp[worst], mj[worst]))
    moved = [k for k in p0 if np.abs(pj[k] - p0[k]).any()]
    # the last stage's fusion convs that feed nothing stay put in both
    assert len(moved) > 0.8 * len(p0)
    assert all(k.startswith("backbone/fuse2/") for k in p0 if k not in moved)
    worst = max(moved, key=lambda k: rel_norm(pp[k] - p0[k], pj[k] - p0[k]))
    err = rel_norm(pp[worst] - p0[worst], pj[worst] - p0[worst])
    assert err <= 5e-2, (worst, err)
    assert all(np.array_equal(pp[k], p0[k]) for k in p0 if k not in moved)
    d = tmp_path / "port" / "ckpts"
    for name in ("best_model", "checkpoint_epoch_1", "checkpoint_epoch_2", "final_model"):
        assert (d / name / ckpt.ARRAYS).is_file()


def test_pose_trainer_resume_is_bit_equal_and_keeps_the_rate(tmp_path, monkeypatch):
    """A run of 2 epochs and a run resumed from checkpoint_epoch_1 end on
    the same weights, statistics and moments bit for bit. The plateau
    scheduler is scripted to halve the rate at the first validation, so
    the rate in the checkpoint (float32, opt_state/hyperparams) is what
    the resumed run must train its second epoch at; the scheduler itself
    starts again at scale 1.0 after the resume, as in the JAX trainer."""
    monkeypatch.setattr(ReduceLROnPlateau, "step", lambda self, loss: 0.5)
    cfg = _cfg(port_config, tmp_path, "run")
    full = PoseTrainer(cfg, device="cpu")
    _port_train(full)
    half = np.float32(0.5e-3)
    assert full.learning_rate == float(half)
    saved = ckpt.read_arrays(cfg.train.checkpoint_dir, "checkpoint_epoch_1", ("opt_state",))
    assert saved["opt_state"]["hyperparams"]["learning_rate"] == half

    again = PoseTrainer(cfg, device="cpu")
    again.resume("checkpoint_epoch_1")
    assert again.start_epoch == 1 and again.state.step == 2
    assert again.learning_rate == float(half) and again.plateau.scale == 1.0
    _port_train(again, start=2)
    a, b = full.state, again.state
    assert a.step == b.step == 4
    for (n, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), n
    ma, mb = ckpt.flatten_tree(a.opt_state()), ckpt.flatten_tree(b.opt_state())
    assert set(ma) == set(mb)
    for k in ma:
        assert np.array_equal(ma[k], mb[k]), k
    # without the restored rate the second epoch differs
    fresh = PoseTrainer(cfg, device="cpu")
    fresh.resume("checkpoint_epoch_1")
    fresh.state.hyperparams["learning_rate"] = 1e-3
    _port_train(fresh, start=2)
    assert not all(torch.equal(x, y) for x, y in zip(a.model.parameters(),
                                                       fresh.state.model.parameters()))


def test_pose_trainer_early_stopping_is_min_mode_on_val_loss(tmp_path, monkeypatch):
    """Early stopping watches the validation loss in min mode (patience
    ``early_stopping_patience``): a loss that stops falling ends the run
    and the best state is restored."""
    cfg = _cfg(port_config, tmp_path, "es").override(
        {"train": {"num_epochs": 6, "steps_per_epoch": 1, "early_stopping_patience": 1}})
    losses = iter([0.5, 0.4, 0.45, 0.3, 0.2, 0.1])
    trainer = PoseTrainer(cfg, device="cpu")
    real = trainer.validate

    def scripted(val, recal):
        out = real(val, recal)
        out["loss"] = next(losses)
        return out

    monkeypatch.setattr(trainer, "validate", scripted)
    t = [tuple(torch.from_numpy(a) for a in b) for b in itertools.islice(
        itertools.cycle(TRAIN), 6)]
    v = [tuple(torch.from_numpy(a) for a in b) for b in VAL]
    hist = trainer.train(iter(t), lambda: v, lambda: [torch.from_numpy(RECAL[0])])
    assert hist["val_loss"] == [0.5, 0.4, 0.45]
    assert trainer.best_metric == 0.4
