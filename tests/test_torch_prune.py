"""The port's pruning (``compression/prune.py``) against the JAX package's,
on the CPU, on the full seeded tree of the full-width model (LR-ASPP /
MobileNetV3-Large, 4,201,348 parameters): magnitude and structured masks
exactly equal, ``sparsity_report`` dicts equal, three fp32 masked AdamW
fine-tune steps at 64x48 b2 within the train-step gate of
``tests/test_torch_train.py``, and
``prune_seg_torch.py`` end to end with ``--device cpu``.

The JAX side is built once per module (jitted: each prune call takes ~17 s
eagerly on the full tree). Step gate: loss 1e-5 relative at every step;
after the first step, the optimizer's first moment (the masked gradient
times 0.1) and the square root of its second moment, tensor by tensor,
within 1e-4 of the tensor's largest entry, with the BN biases whose
gradient is zero in exact arithmetic held below 1e-5 of the model's largest
entry (the gradient gate of ``tests/test_torch_train.py``). After that
only the losses are compared: Adam moves every weight by about the learning
rate in the direction of its gradient's sign, so a weight whose gradient is
at rounding level moves either way in the two packages, and the later
steps' gradients start from parameters that differ there.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mtg_card_image_segmentation_tpu import compression as jax_prune
from mtg_card_image_segmentation_tpu.config import OptimizerConfig as JaxOptimizerConfig
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.training import loop as jax_loop
from mtg_card_image_segmentation_tpu.training.optim import (
    create_optimizer as jax_create_optimizer,
)
from mtg_card_image_segmentation_tpu.training.state import SegTrainState as JaxState

import prune_seg_torch
from mtg_card_image_segmentation_tpu_torch.compression import (
    apply_masks,
    magnitude_prune,
    masked_optimizer,
    sparsity_report,
    structured_channel_prune,
)
from mtg_card_image_segmentation_tpu_torch.compression.slim import expansion_channel_prune
from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
from mtg_card_image_segmentation_tpu_torch.training.loop import make_train_step
from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    init_flax_like,
    trainable_from_flax,
)

torch.set_num_threads(2)

H, W, B = 64, 48, 2
AMOUNT = 0.3
ADAMW = dict(name="adamw", schedule="constant", warmup_epochs=0, learning_rate=1e-3,
             weight_decay=1e-4)
SMALL = ["--set", f"model.input_height={H}", f"model.input_width={W}", "data.batch_size=2"]


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
def jax_pruned(weights):
    """The JAX package's (pruned params, masks) per method, built once."""
    params = jax.tree.map(jnp.asarray, weights[0])
    out = {}
    for name, fn in (("magnitude", jax_prune.magnitude_prune),
                     ("structured", jax_prune.structured_channel_prune)):
        p, m = jax.jit(fn, static_argnums=1)(params, AMOUNT)
        out[name] = (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, m))
    return out


PORT = {"magnitude": magnitude_prune, "structured": structured_channel_prune}


@pytest.mark.parametrize("method", ["magnitude", "structured"])
def test_masks_equal_jax(method, weights, jax_pruned):
    """Masks and pruned params equal the JAX package's exactly, on every
    leaf (131 kernels and BN affines, the non-prunable ones all ones)."""
    p, m = PORT[method](weights[0], AMOUNT)
    jp, jm = (_leaves(t) for t in jax_pruned[method])
    gp, gm = _leaves(p), _leaves(m)
    assert set(gm) == set(jm) and set(gp) == set(jp)
    for k in jm:
        assert gm[k].dtype == jm[k].dtype and np.array_equal(gm[k], jm[k]), k
        assert np.array_equal(gp[k], jp[k]), k
    zeros = sum(int((v == 0).sum()) for v in gm.values())
    assert zeros > 0.2 * sum(v.size for k, v in gm.items() if k.endswith("kernel"))


@pytest.mark.parametrize("method", ["magnitude", "structured"])
def test_sparsity_report_equal_jax(method, weights, jax_pruned):
    p, _ = PORT[method](weights[0], AMOUNT)
    got = sparsity_report(p)
    assert got == jax_prune.sparsity_report(jax_pruned[method][0])
    if method == "magnitude":
        assert abs(got["global_sparsity"] - AMOUNT) < 1e-3
        assert got["prunable_params"] == 4_171_608


def test_structured_prunes_output_channels_of_hwio(weights):
    """Structured pruning removes whole output channels, the last axis of
    the Flax layout (HWIO): in the model's OIHW weights the zeros are whole
    rows of axis 0."""
    p, m = structured_channel_prune(weights[0], AMOUNT)
    k = m["backbone"]["block12"]["expand"]["conv"]["kernel"]  # (1, 1, 112, 672)
    dead = np.nonzero(k.reshape(-1, 672).max(axis=0) == 0)[0]
    assert dead.size == int(AMOUNT * 672)
    model = trainable_from_flax(p, weights[1], dtype=torch.float32)
    w = model.backbone.block12.expand.conv.weight.detach().numpy()  # (672, 112, 1, 1)
    assert np.all(w[dead] == 0) and np.all(np.abs(w[np.setdiff1d(np.arange(672), dead)]).max(
        axis=(1, 2, 3)) > 0)


def test_apply_masks(weights):
    p, m = magnitude_prune(weights[0], AMOUNT)
    again = apply_masks(weights[0], m)
    for k, v in _leaves(p).items():
        assert np.array_equal(_leaves(again)[k], v), k


def _batch(seed):
    """Smooth images and masks a model can learn: mask = red channel > 0."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.standard_normal((B, 3, H // 8, W // 8)).astype(np.float32))
    imgs = torch.nn.functional.interpolate(base, size=(H, W), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1)
    imgs = imgs.contiguous().numpy()
    return imgs, (imgs[..., 0] > 0).astype(np.int32)


@pytest.fixture(scope="module")
def finetune(weights, jax_pruned):
    """Three fp32 masked AdamW steps on one batch, from the magnitude-pruned
    weights, in both packages."""
    pruned, masks = jax_pruned["magnitude"]
    imgs, lbl = _batch(1)
    tx, _ = jax_create_optimizer(JaxOptimizerConfig(**ADAMW), 1, 10)
    tx = jax_prune.masked_optimizer(tx, jax.tree.map(jnp.asarray, masks))
    jstate = JaxState.create(
        apply_fn=jax_create_model("lraspp_mobilenet_v3_large", compute_dtype="float32").apply,
        params=jax.tree.map(jnp.asarray, pruned),
        batch_stats=jax.tree.map(jnp.asarray, weights[1]), tx=tx)
    jstep = jax_loop.make_train_step(donate=False)
    jlosses = []
    for i in range(3):
        jstate, stats = jstep(jstate, imgs, lbl)
        jlosses.append(float(stats["loss"]))
        if i == 0:
            jfirst = {k: jax.tree.map(np.asarray, optax.tree_utils.tree_get(jstate.opt_state, k))
                      for k in ("mu", "nu")}

    opt_def, _ = create_optimizer(OptimizerConfig(**ADAMW), 1, 10)
    model = trainable_from_flax(pruned, weights[1], dtype=torch.float32)
    state = create_seg_state(model, masked_optimizer(opt_def, masks, model))
    step = make_train_step()
    losses = []
    for i in range(3):
        state, stats = step(state, torch.from_numpy(imgs), torch.from_numpy(lbl))
        losses.append(float(stats["loss"]))
        if i == 0:
            first = {k: _leaves(state.opt_state()[k]) for k in ("mu", "nu")}
    return {"jax": (jstate, jlosses), "port": (state, losses), "masks": masks,
            "first_moments": (jfirst, first)}


def test_masked_finetune_loss_matches_jax(finetune):
    (_, want), (_, got) = finetune["jax"], finetune["port"]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)
    assert got[2] < got[0]


def test_masked_finetune_keeps_pruned_weights_at_zero(finetune):
    """Every masked entry is exactly 0 after three AdamW steps (weight decay
    included) in the port, as in the JAX package; the unmasked ones moved."""
    masks = _leaves(finetune["masks"])
    got = _leaves(finetune["port"][0].variables()["params"])
    want = _leaves(jax.tree.map(np.asarray, finetune["jax"][0].params))
    n_masked = 0
    for k, m in masks.items():
        assert np.all(got[k][m == 0] == 0) and np.all(want[k][m == 0] == 0), k
        n_masked += int((m == 0).sum())
    assert abs(n_masked - AMOUNT * 4_171_608) <= 1
    k = "backbone/block0/depthwise/conv/kernel"
    assert np.abs(got[k] - _leaves(init_flax_like(0)[0])[k])[masks[k] == 1].min() > 0


def test_masked_finetune_first_moments_match_jax(finetune):
    """AdamW's first moment and the root of its second moment after the
    first masked step, tensor by tensor (see the module docstring)."""
    jfirst, first = finetune["first_moments"]
    for key, fn in (("mu", lambda a: a), ("nu", np.sqrt)):
        want = {k: fn(v) for k, v in _leaves(jfirst[key]).items()}
        got = {k: fn(v) for k, v in first[key].items()}
        assert set(got) == set(want) and len(want) == 178
        gmax = max(float(np.abs(w).max()) for w in want.values())
        for k, w in want.items():
            if np.abs(w).max() <= 1e-5 * gmax:  # zero in exact arithmetic
                assert np.abs(got[k]).max() <= 1e-5 * gmax, (key, k)
                continue
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{key} {k}")
    assert finetune["port"][0].step == 3


def test_train_state_trees_are_snapshots(weights):
    """``variables()`` and ``opt_state()`` on the CPU are copies, not views
    of the live tensors (a float32 CPU tensor's ``.numpy()`` shares its
    memory): a later step leaves them as they were."""
    opt_def, _ = create_optimizer(OptimizerConfig(**ADAMW), 1, 10)
    state = create_seg_state(trainable_from_flax(*weights, dtype=torch.float32), opt_def)
    imgs, lbl = (torch.from_numpy(a) for a in _batch(2))
    step = make_train_step()
    step(state, imgs, lbl)
    before = {k: _leaves(v) for k, v in (("vars", state.variables()),
                                         ("opt", state.opt_state()))}
    kept = {k: {p: a.copy() for p, a in v.items()} for k, v in before.items()}
    step(state, imgs, lbl)
    for k, v in before.items():
        for p, a in v.items():
            assert np.array_equal(a, kept[k][p]), (k, p)
    bias = "backbone/block0/depthwise/bn/bias"
    assert not np.array_equal(_leaves(state.variables()["params"])[bias],
                              kept["vars"][f"params/{bias}"])


def test_masked_optimizer_checks_the_masks(weights):
    p, m = magnitude_prune(weights[0], AMOUNT)
    opt_def, _ = create_optimizer(OptimizerConfig(**ADAMW), 1, 10)
    model = trainable_from_flax(p, weights[1], dtype=torch.float32)
    del m["head"]["scale"]
    with pytest.raises(ValueError, match="masks"):
        masked_optimizer(opt_def, m, model)


def test_prune_cli_on_cpu(weights, tmp_path):
    """``prune_seg_torch.py --device cpu`` at 64x48 b2 on a seeded
    checkpoint: expansion pruning with a 3-step masked fine-tune, then
    magnitude pruning without one. Each exits 0 and writes
    ``pruned_model`` and ``pruning_report.json`` with the JAX CLI's keys;
    every masked entry is still 0 in the saved file, and the sparsity after
    the fine-tune equals the sparsity before it."""
    ckpt.save_params(str(tmp_path), "final_model", *weights)
    src = str(tmp_path / "final_model")
    out = tmp_path / "expansion"
    report = prune_seg_torch.main(["--checkpoint", src, "--device", "cpu",
                                   "--method", "expansion", "--amount", "0.3",
                                   "--fine-tune-epochs", "1", "--fine-tune-steps", "3",
                                   "--eval-batches", "1", "--output-dir", str(out), *SMALL])
    assert {"pruned_model", "pruning_report.json"} <= set(os.listdir(out))
    on_disk = json.loads((out / "pruning_report.json").read_text())
    assert set(on_disk) == {"method", "amount", "before", "after", "iou_card_delta",
                            "sparsity"}
    assert on_disk == json.loads(json.dumps(report))
    saved, _, _ = ckpt.load_params(str(out), "pruned_model")
    _, masks = expansion_channel_prune(weights[0], 0.3)
    for k, m in _leaves(masks).items():
        assert np.all(_leaves(saved)[k][m == 0] == 0), k
    assert sparsity_report(saved)["global_sparsity"] == report["sparsity"]["global_sparsity"]
    assert "opt_state" in ckpt.read_arrays(str(out), "pruned_model", ("opt_state",))

    report = prune_seg_torch.main(["--checkpoint", src, "--device", "cpu",
                                   "--method", "magnitude", "--amount", "0.3",
                                   "--eval-batches", "1",
                                   "--output-dir", str(tmp_path / "magnitude"), *SMALL])
    assert abs(report["sparsity"]["global_sparsity"] - 0.3) <= 1e-3
    saved, _, _ = ckpt.load_params(str(tmp_path / "magnitude"), "pruned_model")
    assert sparsity_report(saved)["global_sparsity"] == report["sparsity"]["global_sparsity"]


def test_prune_cli_defaults_to_the_card(weights, tmp_path, monkeypatch):
    ckpt.save_params(str(tmp_path), "final_model", *weights)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prune_seg_torch.main(["--checkpoint", str(tmp_path / "final_model"), *SMALL])
