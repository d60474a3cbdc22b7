"""The port's segmentation training on the full-width model (LR-ASPP /
MobileNetV3-Large, 4,201,348 parameters) against the JAX package's, fp32 on
the CPU at 64x48 b2, from the same seeded weights (BN statistics moved off
their init values) and the same numpy-seeded batches.

fp32 XLA:CPU and fp32 PyTorch differ only in summation order: losses agree
to 1e-5 relative, each gradient tensor to 1e-4 of its largest entry, the
BatchNorm statistics to 1e-5 (chip_smoke.py holds the card to the same
gates against the CPU, with 1e-4 for the statistics).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.config import OptimizerConfig as JaxOptimizerConfig
from mtg_card_image_segmentation_tpu import losses as jax_losses
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.training import loop as jax_loop
from mtg_card_image_segmentation_tpu.training.optim import (
    create_optimizer as jax_create_optimizer,
)
from mtg_card_image_segmentation_tpu.training.state import SegTrainState as JaxState

from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig
from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
from mtg_card_image_segmentation_tpu_torch.training.loop import (
    make_eval_step,
    make_train_step,
    recalibrate_batch_stats,
)
from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    init_flax_like,
    state_dict_to_flax,
    trainable_from_flax,
)

torch.set_num_threads(2)

H, W, B = 64, 48, 2
SGD = dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.05,
           weight_decay=1e-4)


def _batch(seed):
    """Smooth images and masks a model can learn: mask = red channel > 0."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.standard_normal((B, 3, H // 8, W // 8)).astype(np.float32))
    imgs = torch.nn.functional.interpolate(base, size=(H, W), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1)
    imgs = imgs.contiguous().numpy()
    return imgs, (imgs[..., 0] > 0).astype(np.int32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def weights():
    return init_flax_like(0)


@pytest.fixture(scope="module")
def jax_model():
    return jax_create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")


def _jax_state(jax_model, weights, opt_cfg):
    tx, _ = jax_create_optimizer(JaxOptimizerConfig(**opt_cfg), 1, 10)
    p, s = (jax.tree.map(jnp.asarray, t) for t in weights)
    return JaxState.create(apply_fn=jax_model.apply, params=p, batch_stats=s, tx=tx)


def _port_state(weights, opt_cfg):
    opt_def, _ = create_optimizer(OptimizerConfig(**opt_cfg), 1, 10)
    return create_seg_state(trainable_from_flax(*weights, dtype=torch.float32), opt_def)


@pytest.fixture(scope="module")
def sgd_step(jax_model, weights):
    """One fp32 SGD train step of both packages from the same weights and
    batch, and the JAX gradients of that step's loss."""
    imgs, masks = _batch(1)
    jstate = _jax_state(jax_model, weights, SGD)

    def loss_fn(params):
        logits, mutated = jax_model.apply(
            {"params": params, "batch_stats": jstate.batch_stats}, imgs, train=True,
            mutable=["batch_stats"])
        return jax_losses.combined_loss(logits, masks)

    jgrads = jax.jit(jax.grad(loss_fn))(jstate.params)
    jnew, jstats = jax_loop.make_train_step(donate=False)(jstate, imgs, masks)
    state = _port_state(weights, SGD)
    state, stats = make_train_step()(state, torch.from_numpy(imgs), torch.from_numpy(masks))
    grads_of = state_dict_to_flax({n: p.grad for n, p in state.model.named_parameters()})[0]
    return {"jax": (jnew, jstats, jgrads), "port": (state, stats, grads_of)}


def test_train_step_loss_matches_jax(sgd_step):
    (_, jstats, _), (_, stats, _) = sgd_step["jax"], sgd_step["port"]
    want, got = float(jstats["loss"]), float(stats["loss"])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    for k in ("iou", "dice", "pixel_accuracy"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-6)


def test_train_step_gradients_match_jax(sgd_step):
    """Every gradient tensor within 1e-4 of its largest entry. The
    projections' BN biases (but block 3's, the low tap) have a gradient that is zero in exact
    arithmetic (the shift reaches the next train-mode BN through a 1x1 conv
    or the residual, and its mean subtraction removes it): in both packages
    they stay below 1e-5 of the model's largest gradient, which every other
    tensor's largest entry exceeds by far (2e-7 against 5e-4 here)."""
    want = _leaves(jax.tree.map(np.asarray, sgd_step["jax"][2]))
    got = _leaves(sgd_step["port"][2])
    assert set(got) == set(want) and len(want) == 178
    gmax = max(float(np.abs(w).max()) for w in want.values())
    zero = {k for k, w in want.items() if np.abs(w).max() <= 1e-5 * gmax}
    # block 3's output is also the low tap, which the head's classifier reads
    assert zero == {f"backbone/block{i}/project/bn/bias" for i in range(15) if i != 3}
    for k, w in want.items():
        if k in zero:
            assert np.abs(got[k]).max() <= 1e-5 * gmax, k
            continue
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def test_train_step_batch_stats_and_sgd_update_match_jax(sgd_step):
    """The running statistics after the step (Flax momentum 0.99, biased
    variance) and the SGD-updated parameters."""
    jnew, state = sgd_step["jax"][0], sgd_step["port"][0]
    var = state.variables()
    want_s = _leaves(jax.tree.map(np.asarray, jnew.batch_stats))
    got_s = _leaves(var["batch_stats"])
    assert set(got_s) == set(want_s)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
    want_p = _leaves(jax.tree.map(np.asarray, jnew.params))
    got_p = _leaves(var["params"])
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert state.step == int(jnew.step) == 1


def test_eval_step_matches_jax(jax_model, weights):
    """make_eval_step: the smoothed stats, and the exact confusion counts
    with the second image weighted out."""
    imgs, masks = _batch(2)
    jstate = _jax_state(jax_model, weights, SGD)
    wts = np.array([1, 0], np.int32)
    jstats, jcm = jax_loop.make_eval_step()(jstate, imgs, masks, wts)
    state = _port_state(weights, SGD)
    stats, cm = make_eval_step()(state, torch.from_numpy(imgs), torch.from_numpy(masks),
                                 torch.from_numpy(wts))
    assert not state.model.training
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert int(cm.sum()) == H * W
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]), rtol=1e-5)
    for k in ("iou", "dice", "pixel_accuracy", "count"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-6)


def test_recalibration_matches_jax(weights):
    """recalibrate_batch_stats over 3 batches: each batch's exact
    statistics (Flax momentum 0), averaged, against the JAX one with its
    momentum-0 model."""
    batches = [_batch(10 + i)[0] for i in range(3)]
    recal_model = jax_create_model("lraspp_mobilenet_v3_large", compute_dtype="float32",
                                   bn_momentum=0.0)
    jstate = _jax_state(jax_create_model("lraspp_mobilenet_v3_large",
                                         compute_dtype="float32"), weights, SGD)
    jnew = jax_loop.recalibrate_batch_stats(jstate, recal_model, batches)
    state = _port_state(weights, SGD)
    momenta = [m.momentum for m in state.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    recalibrate_batch_stats(state, [torch.from_numpy(b) for b in batches])
    assert momenta == [m.momentum for m in state.model.modules()
                       if isinstance(m, torch.nn.BatchNorm2d)]
    want = _leaves(jax.tree.map(np.asarray, jnew.batch_stats))
    got = _leaves(state.variables()["batch_stats"])
    # the statistics moved far from the seeded ones
    assert max(np.abs(got[k] - v).max() for k, v in _leaves(weights[1]).items()) > 0.5
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


ADAMW = dict(name="adamw", schedule="constant", warmup_epochs=0, learning_rate=1e-3,
             weight_decay=1e-4)


def test_resume_is_bit_equal_to_the_uninterrupted_run(weights, tmp_path):
    """AdamW: 2 steps against 1 step, save_checkpoint, load_checkpoint into
    a fresh state, 1 step: parameters, statistics, moments and step equal
    bit for bit on the CPU. The checkpoint also serves through
    SegPredictor.from_checkpoint, as the trained weights do directly."""
    batches = [tuple(torch.from_numpy(a) for a in _batch(20 + i)) for i in range(2)]
    step = make_train_step()
    a = _port_state(weights, ADAMW)
    for imgs, masks in batches:
        step(a, imgs, masks)
    b = _port_state(weights, ADAMW)
    step(b, *batches[0])
    ckpt.save_checkpoint(str(tmp_path), "checkpoint_epoch_1", b, epoch=0,
                         history={"train_loss": [1.0]})
    c = _port_state(init_flax_like(1), ADAMW)
    c, meta = ckpt.load_checkpoint(str(tmp_path), "checkpoint_epoch_1", c)
    assert c.step == 1 and meta["epoch"] == 0 and meta["history"] == {"train_loss": [1.0]}
    step(c, *batches[1])
    for x, y in ((a.variables(), c.variables()), (a.opt_state(), c.opt_state())):
        lx, ly = _leaves(x), _leaves(y)
        assert set(lx) == set(ly)
        for k in lx:
            np.testing.assert_array_equal(lx[k], ly[k], err_msg=k)
    assert a.step == c.step == 2

    ckpt.save_checkpoint(str(tmp_path), "final_model", a, epoch=1)
    images = np.random.default_rng(3).integers(0, 256, (B, H, W, 3), np.uint8)
    served = SegPredictor.from_checkpoint(str(tmp_path), "final_model", H, W,
                                          dtype=torch.float32, device="cpu")
    direct = SegPredictor(*(a.variables()[k] for k in ("params", "batch_stats")), H, W,
                          dtype=torch.float32, device="cpu")
    assert torch.equal(served.predict(images), direct.predict(images))
    with open(os.path.join(tmp_path, "final_model.meta.json")) as f:
        assert json.load(f)["epoch"] == 1
