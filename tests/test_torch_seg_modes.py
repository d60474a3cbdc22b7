"""The serving modes of the port's SegPredictor against the JAX package's, on
the CPU: slim (channel-pruned) widths, int8 weights, checkpoints.

Inputs and weights come from numpy seeds; sizes are small (64x48, b2) at the
model's full width. On the CPU the kernel path runs the kernels' plain
versions.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.compression import slim as jax_slim
from mtg_card_image_segmentation_tpu.export import quantize as jax_quant
from mtg_card_image_segmentation_tpu.ops.pallas.fused_block import (
    fused_tail_chain as jax_chain,
)
from mtg_card_image_segmentation_tpu.serving import predictor as jax_pred

from mtg_card_image_segmentation_tpu_torch.compression import slim
from mtg_card_image_segmentation_tpu_torch.export import quantize as quant
from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import (
    BlockWeights,
    fused_inverted_residual,
    fused_tail_chain,
    inverted_residual_plain,
)
from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import PosePredictor
from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    count_parameters,
    init_flax_like,
    init_hrnet_flax_like,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
H, W, B = 64, 48, 2


@pytest.fixture(scope="module")
def weights():
    return init_flax_like(0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).integers(0, 256, (B, H, W, 3), np.uint8)


@pytest.fixture(scope="module")
def slimmed(weights):
    params, stats = weights
    pruned, masks = slim.expansion_channel_prune(params, 0.3)
    return pruned, masks, slim.slim_seg_state(pruned, stats)


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if hasattr(a[k], "items"):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, f"{path}/{k}"
            np.testing.assert_array_equal(x, y, err_msg=f"{path}/{k}")


# --------------------------------------------------------------------------
# slim
# --------------------------------------------------------------------------


def test_slim_trees_equal_the_jax_package(weights, slimmed):
    """expansion_channel_prune, its masks, dead_expansion_channels,
    slim_seg_state and param_count give the JAX package's results leaf by
    leaf (exact: the same numpy operations)."""
    params, stats = weights
    pruned, masks, (sp, ss, overrides) = slimmed
    j_pruned, j_masks = jax_slim.expansion_channel_prune(params, 0.3)
    _assert_trees_equal(pruned, j_pruned)
    _assert_trees_equal(masks, j_masks)
    dead, j_dead = slim.dead_expansion_channels(pruned), jax_slim.dead_expansion_channels(j_pruned)
    assert set(dead) == set(j_dead)
    for i in dead:
        np.testing.assert_array_equal(dead[i], j_dead[i])
    j_sp, j_ss, j_over = jax_slim.slim_seg_state(j_pruned, stats)
    _assert_trees_equal(sp, j_sp)
    _assert_trees_equal(ss, j_ss)
    assert overrides == j_over
    assert overrides[12:] == (471, 672, 672)  # the widths the tail kernels must take
    assert slim.param_count(sp) == jax_slim.param_count(j_sp) == count_parameters(sp)
    assert slim.param_count(sp) < slim.param_count(params)


def test_block_weights_pad_odd_widths_without_changing_the_block(slimmed):
    """A width that is no multiple of 8 (471) is widened to 472 with zero
    channels in BlockWeights.from_flax; the block's output is bit-equal to
    the unpadded arithmetic, computed here from hand-made weights at 471."""
    _, _, (sp, ss, _) = slimmed
    folded = fold_batch_norm(sp, ss)["backbone"]["block12"]
    bw = BlockWeights.from_flax(folded, 5)
    assert bw.cexp == 472 and bw.exp_w.shape == (472, 112) and bw.proj_w.shape == (160, 472)
    assert float(bw.exp_w[471].abs().max()) == 0 and float(bw.dw_w[:, 471].abs().max()) == 0
    assert float(bw.se1_w[471].abs().max()) == 0 and float(bw.se2_w[:, 471].abs().max()) == 0
    assert float(bw.se2_b[471]) == 0 and float(bw.proj_w[:, 471].abs().max()) == 0
    raw = BlockWeights(
        kernel_size=5, dw_w=bw.dw_w[:, :471], dw_b=bw.dw_b[:471], proj_w=bw.proj_w[:, :471],
        proj_b=bw.proj_b, exp_w=bw.exp_w[:471], exp_b=bw.exp_b[:471], se1_w=bw.se1_w[:471],
        se1_b=bw.se1_b, se2_w=bw.se2_w[:, :471], se2_b=bw.se2_b[:471])
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, 6, 112))
                         .astype(np.float32)).to(torch.bfloat16)
    got = fused_inverted_residual(x, bw, 5, 1, "hardswish", False, 2)
    want = inverted_residual_plain(x, raw, 1, "hardswish", False, 2, torch.bfloat16)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="multiple of 8"):
        BlockWeights.from_flax({k: v for k, v in folded.items() if k != "expand"}, 5)


def test_slim_tail_chain_matches_jax_kernel(slimmed):
    """The port's chain at the slim widths 471/672/672 (plain version, CPU)
    against the JAX fused_tail_chain in interpret mode, bf16, max|d| <= 0.06
    (the JAX package's own bar for the chain, tests/test_pallas_fused_block.py)."""
    _, _, (sp, ss, _) = slimmed
    folded = fold_batch_norm(sp, ss)["backbone"]
    plist = [folded[f"block{i}"] for i in (12, 13, 14)]
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 112)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    theirs = jax_chain(xj, jax.tree.map(jnp.asarray, plist), kernel_size=5,
                       act="hardswish", dilation=2, interpret=True)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    ours = fused_tail_chain(xt, plist, kernel_size=5, act="hardswish", dilation=2)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (2, 8, 8, 160)
    d = np.abs(ours.float().numpy() - np.asarray(theirs.astype(jnp.float32)))
    assert d.max() <= 0.06, d.max()


def test_slim_predictor_equals_masked_and_matches_jax(weights, slimmed, images):
    """fp32: the slim predictor's masks equal the masked dense predictor's on
    both paths (the same operations on the surviving channels), and agree
    >= 0.999 with the JAX predictor's reference path on the masked dense
    weights (its reference path builds the dense model only; slim equals
    masked there too, tests/test_slim.py)."""
    _, stats = weights
    pruned, _, (sp, ss, _) = slimmed
    kw = dict(dtype=torch.float32, device="cpu")
    for use_kernels in (True, False):
        slim_masks = SegPredictor(sp, ss, H, W, use_kernels=use_kernels, **kw).predict(images)
        masked = SegPredictor(pruned, stats, H, W, use_kernels=use_kernels, **kw).predict(images)
        assert (slim_masks == masked).float().mean() >= 0.9999
    theirs = np.asarray(jax_pred.SegPredictor(
        jax.tree.map(jnp.asarray, pruned), jax.tree.map(jnp.asarray, stats), H, W,
        use_pallas=False, dtype=jnp.float32, auto_layout=False).predict(images))
    assert (slim_masks.numpy() == theirs).mean() >= 0.999


# --------------------------------------------------------------------------
# int8 weights
# --------------------------------------------------------------------------


def test_quantize_trees_equal_the_jax_package(weights):
    """quantize_params and dequantize_params (numpy) give the JAX package's
    trees exactly; the torch shim gives the same dense kernels."""
    folded = fold_batch_norm(*weights)
    q, jq = quant.quantize_params(folded), jax_quant.quantize_params(folded)
    _assert_trees_equal(q, jq)
    assert q["backbone"]["block13"]["expand"]["conv"]["kernel_q"].dtype == np.int8
    assert "kernel" in q["backbone"]["stem"]["conv"]  # 432 < 512 elements: dense
    d, jd = quant.dequantize_params(q), jax_quant.dequantize_params(jq)
    _assert_trees_equal(d, jd)
    tq = slim.tree_map(torch.from_numpy, q)
    td = quant.dequantize_params(tq, torch.float32, xp=quant.torch_xp)
    _assert_trees_equal(slim.tree_map(lambda t: t.numpy(), td), d)


def test_int8_predictor_keeps_int8_and_matches_jax(weights, images):
    """quantize="int8", fp32: int8 leaves and float32 scales persist in the
    predictor, its masks agree >= 0.999 with the JAX int8 predictor
    (reference path; both compute with float32(int8) * scale), and >= 0.99
    with the unquantized predictor (the repo's floor for random weights,
    tests/test_serving.py:141-165). An unknown mode raises."""
    params, stats = weights
    kw = dict(dtype=torch.float32, device="cpu")
    q = SegPredictor(params, stats, H, W, quantize="int8", **kw)
    leaves = []
    slim.tree_map(leaves.append, q._qparams)
    assert any(t.dtype == torch.int8 for t in leaves)
    assert all(t.dtype in (torch.int8, torch.float32) for t in leaves)
    theirs = np.asarray(jax_pred.SegPredictor(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats), H, W,
        use_pallas=False, dtype=jnp.float32, quantize="int8",
        auto_layout=False).predict(images))
    ours = q.predict(images).numpy()
    assert (ours == theirs).mean() >= 0.999
    qref = SegPredictor(params, stats, H, W, quantize="int8", use_kernels=False, **kw)
    assert (qref.predict(images).numpy() == theirs).mean() >= 0.999
    assert q.mask_agreement(SegPredictor(params, stats, H, W, **kw), images) >= 0.99
    with pytest.raises(ValueError, match="unknown quantize mode"):
        SegPredictor(params, stats, H, W, quantize="int4", **kw)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def test_save_load_round_trip_and_swap(weights, tmp_path):
    """save_params writes what load_params reads (exact), with the sidecar;
    a second save replaces the first and leaves no staging directory."""
    params, stats = weights
    path = ckpt.save_params(str(tmp_path), "best_model", params, stats, epoch=3,
                            best_metric=0.9, config={"model": "seg"})
    assert os.path.isfile(os.path.join(path, ckpt.ARRAYS))
    p2, s2, meta = ckpt.load_params(str(tmp_path), "best_model")
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, stats)
    assert meta["epoch"] == 3 and meta["best_metric"] == 0.9 and meta["config"] == {"model": "seg"}
    other = slim.tree_map(lambda a: a + 1, params)
    os.makedirs(path + ".staging")  # a stale staging directory of a killed save
    ckpt.save_params(str(tmp_path), "best_model", other, stats, epoch=4)
    p3, _, meta = ckpt.load_params(str(tmp_path), "best_model")
    _assert_trees_equal(p3, other)
    assert meta["epoch"] == 4
    assert sorted(os.listdir(tmp_path)) == ["best_model", "best_model.meta.json"]


def test_sidecar_only_directory_raises(tmp_path):
    """A directory that holds only the .meta.json (checkpoint binaries are
    not tracked in git) raises FileNotFoundError with the reference's text."""
    (tmp_path / "best_model.meta.json").write_text(json.dumps({"epoch": 1}))
    with pytest.raises(FileNotFoundError, match="checkpoint binaries are not tracked"):
        ckpt.load_params(str(tmp_path), "best_model")
    (tmp_path / "best_model").mkdir()
    with pytest.raises(FileNotFoundError, match="directory missing or empty"):
        SegPredictor.from_checkpoint(str(tmp_path), "best_model", H, W, device="cpu")


def test_from_checkpoint_predictors_equal_direct_ones(weights, images, tmp_path):
    """SegPredictor.from_checkpoint and PosePredictor.from_checkpoint give
    the outputs of predictors built from the same trees (exact)."""
    params, stats = weights
    ckpt.save_params(str(tmp_path), "seg", params, stats)
    a = SegPredictor.from_checkpoint(str(tmp_path), "seg", H, W, device="cpu")
    b = SegPredictor(params, stats, H, W, device="cpu")
    assert torch.equal(a.predict(images), b.predict(images))
    hp, hs = init_hrnet_flax_like(0)
    ckpt.save_params(str(tmp_path), "pose", hp, hs)
    kw = dict(heatmap_hw=(16, 12), dtype=torch.float32, device="cpu")
    pa = PosePredictor.from_checkpoint(str(tmp_path), "pose", H, W, **kw)
    pb = PosePredictor(hp, hs, H, W, **kw)
    for x, y in zip(pa.predict(images), pb.predict(images)):
        assert torch.equal(x, y)


def test_orbax_checkpoint_converts_to_equal_arrays(tmp_path):
    """JAX save_checkpoint (Orbax) -> tools/orbax_to_torch_checkpoint.py ->
    port load_params: equal arrays, and the sidecar carried over."""
    import optax

    from mtg_card_image_segmentation_tpu.models import create_model
    from mtg_card_image_segmentation_tpu.training import create_seg_state
    from mtg_card_image_segmentation_tpu.training.checkpoint import save_checkpoint

    sys.path.insert(0, str(REPO / "tools"))
    try:
        import orbax_to_torch_checkpoint as conv
    finally:
        sys.path.remove(str(REPO / "tools"))
    model = create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")
    state = create_seg_state(model, optax.sgd(1e-3), (1, 32, 32, 3), jax.random.key(0))
    src = tmp_path / "orbax"
    save_checkpoint(str(src), "best_model", state, epoch=7, best_metric=0.5,
                    config={"from": "jax"})
    out = conv.convert(str(src), "best_model", str(tmp_path / "torch"), "best_model")
    assert os.path.isfile(os.path.join(out, ckpt.ARRAYS))
    params, stats, meta = ckpt.load_params(str(tmp_path / "torch"), "best_model")
    _assert_trees_equal(params, jax.tree.map(np.asarray, state.params))
    _assert_trees_equal(stats, jax.tree.map(np.asarray, state.batch_stats))
    assert meta["epoch"] == 7 and meta["config"] == {"from": "jax"}
    # and the port builds a predictor from it
    SegPredictor.from_checkpoint(str(tmp_path / "torch"), "best_model", 32, 32,
                                 dtype=torch.float32, device="cpu")
