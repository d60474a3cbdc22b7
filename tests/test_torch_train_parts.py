"""The parts of the port's segmentation training against the JAX package's,
on the CPU, on the same numpy-seeded inputs: config, losses, metrics,
schedules, optimizer updates, BatchNorm train mode, early stopping,
checkpoints, and the trainer's epoch loop on a two-conv model.

Tolerances: float32 functions of the same inputs 1e-6 relative (summation
order only; 2e-6 for the losses, means over 576 values); confusion counts
exact; schedules 1e-6 relative or of the peak rate to optax's float32
values at every step; optimizer updates 1e-6.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
import optax

from mtg_card_image_segmentation_tpu import config as jax_config
from mtg_card_image_segmentation_tpu import losses as jax_losses
from mtg_card_image_segmentation_tpu import metrics as jax_metrics
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.models.layers import ConvBNAct as JaxConvBNAct
from mtg_card_image_segmentation_tpu.training import loop as jax_loop
from mtg_card_image_segmentation_tpu.training import optim as jax_optim

from mtg_card_image_segmentation_tpu_torch import config as port_config
from mtg_card_image_segmentation_tpu_torch import losses, metrics
from mtg_card_image_segmentation_tpu_torch.models import registry
from mtg_card_image_segmentation_tpu_torch.models.layers import ConvBNAct
from mtg_card_image_segmentation_tpu_torch.models.lraspp import conv1x1
from mtg_card_image_segmentation_tpu_torch.ops.resize import bilinear_resize
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
from mtg_card_image_segmentation_tpu_torch.training import optim
from mtg_card_image_segmentation_tpu_torch.training.loop import EarlyStopping, batch_norms
from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
from mtg_card_image_segmentation_tpu_torch.utils.logging import setup_logger
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    flax_to_state_dict,
    from_flax,
    init_flax_defaults,
    init_flax_like,
    trainable_from_flax,
)

torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

OVERRIDES = [
    {},
    {"model": {"input_height": 64, "compute_dtype": "float32"},
     "optimizer": {"name": "sgd", "warmup_epochs": 0, "grad_clip_norm": 1.0},
     "train": {"num_epochs": 3, "steps_per_epoch": 5},
     "data": {"augment": {"scale_range": [0.5, 1.5]}}},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_config_copy_equals_the_original(overrides, tmp_path):
    """The copy's tree, defaults and overrides (dict, JSON file, CLI pairs)
    give the original's to_dict()."""
    ours = port_config.Config().override(overrides)
    theirs = jax_config.Config().override(overrides)
    assert ours.to_dict() == theirs.to_dict()
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(overrides))
    assert port_config.Config.from_json(str(path)).to_dict() == theirs.to_dict()
    cli = ["train.num_epochs=7", "optimizer.schedule=cosine_restarts", "data.source=synthetic"]
    assert (port_config.Config().with_cli(cli).to_dict()
            == jax_config.Config().with_cli(cli).to_dict())
    assert (port_config.pose_default_config().to_dict()
            == jax_config.pose_default_config().to_dict())
    with pytest.raises(KeyError):
        port_config.Config().override({"train": {"nope": 1}})


# --------------------------------------------------------------------------
# losses and metrics
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seg_batch():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 16, 12, 2)).astype(np.float32)
    targets = (rng.random((3, 16, 12)) < 0.4).astype(np.int32)
    return logits, targets


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_losses_match_jax(seg_batch, dtype):
    logits, targets = seg_batch
    jl = jnp.asarray(logits).astype(dtype)
    tl = _t(logits).to(getattr(torch, dtype))
    weights = np.array([0.3, 1.7], np.float32)
    cases = [
        (losses.dice_loss(tl, _t(targets)), jax_losses.dice_loss(jl, targets)),
        (losses.cross_entropy_loss(tl, _t(targets)), jax_losses.cross_entropy_loss(jl, targets)),
        (losses.cross_entropy_loss(tl, _t(targets), _t(weights)),
         jax_losses.cross_entropy_loss(jl, targets, jnp.asarray(weights))),
        (losses.combined_loss(tl, _t(targets), 0.3, 0.7),
         jax_losses.combined_loss(jl, targets, 0.3, 0.7)),
        (losses.heatmap_mse_loss(tl, _t(logits[::-1].copy())),
         jax_losses.heatmap_mse_loss(jl, logits[::-1])),
    ]
    # float32 means over 576 values in another order: ~sqrt(576) roundings
    for got, want in cases:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=2e-6)


def test_batch_metrics_match_jax(seg_batch):
    logits, targets = seg_batch
    lt, tt = _t(logits), _t(targets)
    loss = losses.combined_loss(lt, tt)
    ours = metrics.segmentation_batch_stats(loss, lt, tt)
    theirs = jax_metrics.segmentation_batch_stats(jax_losses.combined_loss(logits, targets),
                                                  jnp.asarray(logits), targets)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-6, err_msg=k)
    three = np.random.default_rng(1).standard_normal((2, 8, 8, 3)).astype(np.float32)
    t3 = np.random.default_rng(2).integers(0, 3, (2, 8, 8)).astype(np.int32)
    for fn, jfn in ((metrics.batch_iou, jax_metrics.batch_iou),
                    (metrics.batch_dice, jax_metrics.batch_dice)):
        np.testing.assert_allclose(fn(_t(three), _t(t3), 3).numpy(),
                                   np.asarray(jfn(three, t3, 3)), rtol=1e-6)
    # the accumulators over two batches
    acc, jacc = metrics.MetricsAccumulator(), jax_metrics.MetricsAccumulator()
    for i in range(2):
        acc.update(metrics.segmentation_batch_stats(loss * (i + 1), lt[i:], tt[i:]))
        jacc.update(jax_metrics.segmentation_batch_stats(
            jnp.asarray(float(loss) * (i + 1)), jnp.asarray(logits[i:]), targets[i:]))
    got, want = acc.result(), jacc.result()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    acc.reset()
    assert acc.result() == {}


def test_confusion_counts_equal_jax_exactly(seg_batch):
    """With and without per-image weights (a padded row weighted out), and
    with three classes; then the metrics of the accumulated counts."""
    logits, targets = seg_batch
    pred = np.argmax(logits, -1)
    for w in (None, np.array([1, 0, 1], np.int32)):
        ours = metrics.confusion_matrix(_t(pred), _t(targets), 2,
                                        None if w is None else _t(w))
        theirs = jax_metrics.confusion_matrix(pred, targets, 2, w)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert int(ours.sum()) == 2 * 16 * 12
    rng = np.random.default_rng(3)
    p3, t3 = (rng.integers(0, 3, (2, 5, 7)).astype(np.int32) for _ in range(2))
    np.testing.assert_array_equal(metrics.confusion_matrix(_t(p3), _t(t3), 3).numpy(),
                                  np.asarray(jax_metrics.confusion_matrix(p3, t3, 3)))
    acc, jacc = metrics.ConfusionAccumulator(), jax_metrics.ConfusionAccumulator()
    for _ in range(2):
        acc.update(ours)
        jacc.update(theirs)
    np.testing.assert_array_equal(acc.cm, jacc.cm)
    assert acc.result() == jacc.result()
    assert metrics.metrics_from_confusion(np.zeros((2, 2))) == \
        jax_metrics.metrics_from_confusion(np.zeros((2, 2)))


def test_corner_metrics_match_jax():
    rng = np.random.default_rng(4)
    pred, tgt = (rng.random((6, 4, 2)).astype(np.float32) for _ in range(2))
    for hw in ((480, 640), None):
        d = metrics.corner_distances(_t(pred), _t(tgt), hw)
        jd = jax_metrics.corner_distances(pred, tgt, hw)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
        ours, theirs = metrics.corner_metrics(d * 30), jax_metrics.corner_metrics(jd * 30)
        assert set(ours) == set(theirs)
        for k in ours:
            np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# schedules and optimizer updates
# --------------------------------------------------------------------------

SCHEDULES = [
    dict(schedule="cosine", warmup_epochs=5),
    dict(schedule="cosine", warmup_epochs=0),
    dict(schedule="cosine", warmup_epochs=2, min_lr_ratio=0.05),
    dict(schedule="constant", warmup_epochs=3),
    dict(schedule="constant", warmup_epochs=0),
    dict(schedule="cosine_restarts", warmup_epochs=0),
    dict(schedule="cosine_restarts", warmup_epochs=0, restart_div=3, restart_mult=3),
]


@pytest.mark.parametrize("lr_scale", [1.0, 0.1])
@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedules_match_optax_at_every_step(kw, lr_scale):
    """create_optimizer's schedule against the JAX package's (optax) at every
    step of a 12-epoch x 7-step run and past its end: within 1e-6 relative,
    or 1e-6 of the peak rate (optax's float32 intermediates, e.g. ``1 -
    count / n``, round to ~1e-7 of the peak), and exactly 0 where a warmup
    starts."""
    _, ours = optim.create_optimizer(port_config.OptimizerConfig(**kw), 12, 7, lr_scale)
    _, theirs = jax_optim.create_optimizer(jax_config.OptimizerConfig(**kw), 12, 7, lr_scale)
    steps = np.arange(12 * 7 + 5)
    want = np.asarray(jax.vmap(theirs)(jnp.asarray(steps)), np.float64)
    got = np.array([ours(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 1e-3 * lr_scale)
    if kw["warmup_epochs"]:
        assert got[0] == 0.0


def _param_list(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((4, 3, 3, 3), (8,), (5,))]


@pytest.mark.parametrize("kw", [
    dict(name="adamw", schedule="cosine", warmup_epochs=1, learning_rate=1e-2),
    dict(name="adamw", schedule="constant", warmup_epochs=0, learning_rate=1e-2,
         weight_decay=0.05),
    dict(name="sgd", schedule="cosine", warmup_epochs=1, learning_rate=0.1),
    dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.1,
         grad_clip_norm=0.5),
    dict(name="adamw", schedule="constant", warmup_epochs=0, learning_rate=1e-2,
         grad_clip_norm=100.0),
])
def test_optimizer_updates_match_optax(kw):
    """Three updates from given gradients (the first at the warmup's lr 0,
    where only the moments move): parameters, moments and step within 1e-6
    of optax's (the moments 1e-5 relative: torch takes mu by lerp)."""
    cfg = port_config.OptimizerConfig(**kw)
    opt_def, _ = optim.create_optimizer(cfg, 4, 3)
    tx, _ = jax_optim.create_optimizer(jax_config.OptimizerConfig(**kw), 4, 3)
    init = _param_list(0)
    params = [nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = opt_def.build(params)
    jparams = [jnp.asarray(a) for a in init]
    jstate = tx.init(jparams)
    for i in range(3):
        grads = _param_list(10 + i)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        opt_def.step(opt, i)
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    slots = ({"exp_avg": "mu", "exp_avg_sq": "nu"} if cfg.name == "adamw"
             else {"momentum_buffer": "trace"})
    for slot, key in slots.items():
        for p, m in zip(params, optax.tree_utils.tree_get(jstate, key)):
            np.testing.assert_allclose(opt.state[p][slot].numpy(), np.asarray(m),
                                       rtol=1e-5, atol=1e-9, err_msg=key)
    if cfg.grad_clip_norm is not None and cfg.grad_clip_norm < 1:
        # the gradients were clipped in place to the global norm
        norm = np.sqrt(sum(float((p.grad ** 2).sum()) for p in params))
        assert abs(norm - cfg.grad_clip_norm) < 1e-6


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        optim.create_optimizer(port_config.OptimizerConfig(name="lion"), 10, 10)
    with pytest.raises(ValueError):
        optim.create_schedule(port_config.OptimizerConfig(schedule="step"), 10, 10)


# --------------------------------------------------------------------------
# BatchNorm train mode, the model's train layout
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bn_momentum", [0.99, 0.9, 0.0])
def test_conv_bn_train_mode_matches_flax(bn_momentum):
    """ConvBNAct in train mode vs Flax's at n = 2*2*3 = 12 values per
    channel: output, running mean and running var within 1e-6. torch's own
    BatchNorm2d update (the unbiased variance, off by n/(n-1)) fails the
    same gate."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 4, 6, 3)) * 2 + 0.5).astype(np.float32)
    p = {"conv": {"kernel": (0.3 * rng.standard_normal((3, 3, 3, 5))).astype(np.float32)},
         "bn": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                "bias": rng.standard_normal(5).astype(np.float32)}}
    s = {"bn": {"mean": (0.1 * rng.standard_normal(5)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}}
    jm = JaxConvBNAct(5, 3, stride=2, act="hardswish", bn_momentum=bn_momentum,
                      dtype=jnp.float32)
    jy, mut = jm.apply({"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"])
    tm = ConvBNAct(3, 5, 3, stride=2, act="hardswish", bn_momentum=bn_momentum,
                   dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(p, s))
    y = tm.train()(_t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(tm.bn, name).numpy(),
                                   np.asarray(mut["batch_stats"]["bn"][k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    stock = nn.BatchNorm2d(5, eps=1e-3, momentum=1.0 - bn_momentum)
    stock.load_state_dict({**{k.split(".", 1)[1]: v for k, v in tm.state_dict().items()
                              if k.startswith("bn.")},
                           "running_var": _t(s["bn"]["var"])})
    stock.train()(tm.conv(_t(x).permute(0, 3, 1, 2)))
    assert not np.allclose(stock.running_var.detach().numpy(),
                           np.asarray(mut["batch_stats"]["bn"]["var"]), rtol=1e-6, atol=1e-6)


def test_train_layout_model_in_eval_mode_is_the_serving_model():
    """trainable_from_flax in eval mode gives from_flax's logits bit for bit
    (the serving forward is unchanged), in train mode it differs (batch
    statistics); Flax's default momentum 0.99 reaches every BatchNorm as
    torch's 0.01."""
    params, stats = init_flax_like(0)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 32, 24, 3))
                         .astype(np.float32))
    train = trainable_from_flax(params, stats, dtype=torch.float32)
    assert train.training
    assert len(batch_norms(train)) == 47
    assert all(abs(bn.momentum - 0.01) < 1e-12 for bn in batch_norms(train))
    with torch.no_grad():
        serving = from_flax(params, stats, dtype=torch.float32)(x)
        assert torch.equal(train.eval()(x), serving)
        assert not torch.allclose(train.train()(x), serving)


def test_registry_from_config_and_flax_default_init():
    """from_config builds the full model (4,201,348 parameters);
    init_flax_defaults gives it Flax's default values: truncated LeCun-normal
    kernels within two standard deviations, zero biases, unit BN scale and
    variance. The same seed gives the same weights."""
    cfg = port_config.ModelConfig(compute_dtype="float32")
    model = registry.from_config(cfg)
    assert sum(p.numel() for p in model.parameters()) == 4_201_348
    assert {round(bn.momentum, 12) for bn in batch_norms(model)} == {0.01}
    frozen = registry.create_model(cfg.name, compute_dtype="float32", bn_momentum=0.0)
    assert {bn.momentum for bn in batch_norms(frozen)} == {1.0}
    with pytest.raises(ValueError):
        registry.from_config(dataclasses.replace(cfg, param_dtype="bfloat16"))
    init_flax_defaults(model, 3)
    sd = model.state_dict()
    k = sd["backbone.block13.expand.conv.weight"]  # fan-in 160
    std = (1 / 160) ** 0.5 / 0.87962566103423978
    assert float(k.abs().max()) <= 2 * std and abs(float(k.std()) / (1 / 160) ** 0.5 - 1) < 0.02
    dw = sd["backbone.block13.depthwise.conv.weight"]  # fan-in 25
    assert float(dw.abs().max()) <= 2 * (1 / 25) ** 0.5 / 0.87962566103423978
    assert float(sd["head.low_classifier.bias"].abs().max()) == 0.0
    assert torch.equal(sd["backbone.stem.bn.weight"], torch.ones(16))
    assert torch.equal(sd["backbone.stem.bn.running_var"], torch.ones(16))
    again = init_flax_defaults(registry.from_config(cfg), 3).state_dict()
    assert all(torch.equal(v, again[n]) for n, v in sd.items())
    # the Flax tree of the JAX model's init: same names and shapes
    jv = jax.eval_shape(lambda r: jax_create_model("lraspp_mobilenet_v3_large").init(
        r, jnp.zeros((1, 32, 24, 3)), train=False), jax.random.key(0))
    zeros = [jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jv[k])
             for k in ("params", "batch_stats")]
    assert set(flax_to_state_dict(*zeros)) == set(sd)


def test_resize_after_inference_mode_still_trains():
    """bilinear_resize caches its taps per size and device: a first call
    under inference_mode (a predictor) must not leave tensors that a later
    training step at the same size cannot save for backward."""
    x = torch.randn(2, 5, 7, 3)
    with torch.inference_mode():
        want = bilinear_resize(x, 13, 11)
    y = x.clone().requires_grad_(True)
    got = bilinear_resize(y, 13, 11)
    got.sum().backward()
    assert torch.equal(got.detach(), want)
    assert y.grad is not None and float(y.grad.sum()) == pytest.approx(13 * 11 * 2 * 3, rel=1e-5)


# --------------------------------------------------------------------------
# early stopping (mirrors tests/test_training.py)
# --------------------------------------------------------------------------


def test_early_stopping_max_mode():
    es = EarlyStopping(patience=2, mode="max")
    assert not es(0.5)
    assert not es(0.6)
    assert not es(0.55)
    es2 = EarlyStopping(patience=2, mode="max")
    es2(0.5)
    es2(0.4)
    assert es2(0.4) and es2.should_stop and es2.best == 0.5
    es3 = EarlyStopping(patience=1, min_delta=0.1, mode="max")
    es3(0.5)
    assert es3(0.55)  # inside min_delta: no improvement


def test_early_stopping_min_mode_restore():
    class FakeState:
        def __init__(self, v):
            self.model = nn.Linear(1, 1, bias=False)
            self.model.weight.data.fill_(v)

    es = EarlyStopping(patience=3, mode="min")
    es(1.0, FakeState(1.0))
    es(0.5, FakeState(2.0))  # best
    es(0.7, FakeState(3.0))
    restored = es.restore_best(FakeState(9.0))
    assert float(restored.model.weight.detach()) == 2.0
    assert not es.should_stop and es.counter == 1


# --------------------------------------------------------------------------
# a two-conv model, registered here: checkpoints and the trainer's loop
# --------------------------------------------------------------------------


class TinySeg(nn.Module):
    """The port's counterpart of tests/tiny.py::TinySeg (Flax names c1, c2,
    cls)."""

    def __init__(self, num_classes=2, width=8, bn_momentum=0.99, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.c1 = ConvBNAct(3, width, 3, stride=2, act="relu", bn_momentum=bn_momentum,
                            dtype=dtype)
        self.c2 = ConvBNAct(width, width, 3, act="hardswish", bn_momentum=bn_momentum,
                            dtype=dtype)
        self.cls = nn.Conv2d(width, num_classes, 1)

    def forward(self, x):
        y = conv1x1(self.c2(self.c1(x)), self.cls, self.dtype)
        return bilinear_resize(y.float(), x.shape[1], x.shape[2])


if "tiny_seg" not in registry.available_models():

    @registry.register("tiny_seg")
    def _tiny_seg(num_classes=2, inter_channels=8, compute_dtype="float32",
                  param_dtype="float32", bn_momentum=0.99):
        registry.check_param_dtype(param_dtype)
        return TinySeg(num_classes, inter_channels, bn_momentum,
                       {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype])


def _tiny_state(seed, name="adamw"):
    model = init_flax_defaults(registry.create_model("tiny_seg"), seed)
    opt_def, _ = optim.create_optimizer(
        port_config.OptimizerConfig(name=name, warmup_epochs=0), 1, 10)
    return create_seg_state(model, opt_def)


def _tiny_batch(seed, b=4, hw=16):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    return _t(imgs), _t((imgs[..., 0] > 0).astype(np.int64))


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_checkpoint_round_trip_and_swap(tmp_path, monkeypatch, name):
    """save_checkpoint writes the whole train state and load_checkpoint
    restores it bit for bit into a state from another seed; a save over an
    existing checkpoint with a stale staging directory and one failed write
    (retried) replaces it and leaves no staging behind; load_params reads
    such a checkpoint's parameters and statistics without its optimizer
    arrays; params_only leaves the moments alone."""
    from mtg_card_image_segmentation_tpu_torch.training.loop import make_train_step

    state = _tiny_state(0, name)
    step = make_train_step()
    for i in range(3):
        step(state, *_tiny_batch(i))
    path = ckpt.save_checkpoint(str(tmp_path), "best_model", state, epoch=7, best_metric=0.91,
                                history={"train_loss": [1.0, 0.5]}, config={"x": 1})
    assert os.path.isfile(os.path.join(path, ckpt.ARRAYS))
    fresh = _tiny_state(1, name)
    restored, meta = ckpt.load_checkpoint(str(tmp_path), "best_model", fresh)
    assert restored.step == 3 and meta["epoch"] == 7 and meta["best_metric"] == 0.91
    assert meta["history"]["train_loss"] == [1.0, 0.5] and meta["config"] == {"x": 1}
    _assert_trees_equal(restored.variables(), state.variables())
    _assert_trees_equal(restored.opt_state(), state.opt_state())
    assert set(state.opt_state()) == ({"mu", "nu", "count"} if name == "adamw"
                                      else {"trace", "count"})

    params, stats, meta2 = ckpt.load_params(str(tmp_path), "best_model")
    _assert_trees_equal({"params": params, "batch_stats": stats}, state.variables())
    assert meta2["epoch"] == 7

    os.makedirs(path + ".staging")  # a stale staging directory of a killed save
    real_savez, calls = np.savez, []

    def flaky_savez(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("disk hiccup")
        return real_savez(*a, **kw)

    monkeypatch.setattr(ckpt.np, "savez", flaky_savez)
    step(state, *_tiny_batch(9))
    ckpt.save_checkpoint(str(tmp_path), "best_model", state, epoch=8)
    assert len(calls) == 2
    assert sorted(os.listdir(tmp_path)) == ["best_model", "best_model.meta.json"]
    other = _tiny_state(2, name)
    ckpt.load_checkpoint(str(tmp_path), "best_model", other, params_only=True)
    assert other.step == 4 and not other.optimizer.state
    _assert_trees_equal(other.variables(), state.variables())
    assert ckpt.latest_checkpoint_name(str(tmp_path)) == "best_model"
    assert ckpt.latest_checkpoint_name(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError, match="directory missing or empty"):
        ckpt.load_checkpoint(str(tmp_path), "gone", other)


def test_try_save_checkpoint_logs_and_continues(tmp_path, monkeypatch):
    state = _tiny_state(0)
    monkeypatch.setattr(ckpt.np, "savez", lambda *a, **k: (_ for _ in ()).throw(OSError("full")))
    log = setup_logger(log_dir=str(tmp_path / "logs"))
    assert ckpt.try_save_checkpoint(log, str(tmp_path), "best_model", state, 0) is None
    assert not os.path.exists(tmp_path / "best_model")
    assert any(f.startswith("train_") for f in os.listdir(tmp_path / "logs"))


@pytest.mark.parametrize("opt", [{"name": "adamw", "learning_rate": 1e-2},
                                 {"name": "sgd", "learning_rate": 0.05}])
def test_seg_trainer_history_matches_the_jax_trainer(tmp_path, opt):
    """Two epochs of three steps of the two-conv model in both packages'
    trainers, from the JAX trainer's initial weights and the same batches
    (cosine schedule with its clamped warmup, AdamW or SGD, fp32, log every 2
    steps, validation after recalibration every epoch, a checkpoint every
    epoch): the same history keys, every value within 1e-4; the
    checkpoints and history.json written; resume continues from the last
    periodic checkpoint."""
    import tiny  # noqa: F401  (registers the JAX tiny_seg)
    from mtg_card_image_segmentation_tpu.parallel import make_mesh
    from mtg_card_image_segmentation_tpu.training.trainer import SegTrainer as JaxTrainer

    from mtg_card_image_segmentation_tpu_torch.training.trainer import SegTrainer

    over = {
        "model": {"name": "tiny_seg", "input_height": 32, "input_width": 32,
                  "inter_channels": 8, "compute_dtype": "float32"},
        "data": {"batch_size": 8},
        "optimizer": opt,
        "train": {"num_epochs": 2, "steps_per_epoch": 3, "save_every_epochs": 1,
                  "log_every_steps": 2},
    }

    def cfg(pkg, sub):
        return pkg.Config().override(over).override(
            {"train": {"checkpoint_dir": str(tmp_path / sub / "ckpts"),
                       "log_dir": str(tmp_path / sub / "logs")}})

    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.standard_normal((8, 3, 4, 4)).astype(np.float32))
    imgs = torch.nn.functional.interpolate(base, size=(32, 32), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1)
    imgs = imgs.contiguous().numpy()
    masks = (imgs[..., 0] > 0).astype(np.int32)
    recal = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)

    jt = JaxTrainer(cfg(jax_config, "jax"), mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    init = [jax.tree.map(np.asarray, t) for t in (jt.state.params, jt.state.batch_stats)]
    jhist = jt.train(iter(lambda: (imgs, masks), None), lambda: [(imgs, masks)],
                     lambda: [recal])

    pc = cfg(port_config, "port")
    ours = SegTrainer(pc, device="cpu")
    ours.state.load_variables(*init)
    ti, tm, tr = _t(imgs), _t(masks), _t(recal)
    hist = ours.train(iter(lambda: (ti, tm), None), lambda: [(ti, tm)], lambda: [tr])
    assert set(hist) == set(jhist) and len(hist["train_loss"]) == 2
    assert len(hist["val_exact_mean_iou"]) == 2
    for k in jhist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=0, atol=1e-4, err_msg=k)
    d = tmp_path / "port" / "ckpts"
    for name in ("best_model", "checkpoint_epoch_1", "checkpoint_epoch_2", "final_model"):
        assert (d / name / ckpt.ARRAYS).is_file() and (d / f"{name}.meta.json").is_file()
    assert json.loads((d / "history.json").read_text()) == hist

    again = SegTrainer(pc, device="cpu")
    again.resume("checkpoint_epoch_1")
    assert again.start_epoch == 1 and again.state.step == 3
    assert again.history["train_loss"] == hist["train_loss"][:1]
    latest = SegTrainer(pc, device="cpu")
    latest.resume()
    assert latest.state.step == 6
