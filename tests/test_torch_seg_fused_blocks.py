"""The seg predictor's ``fused_blocks`` and ``fused_chain`` options on the
CPU: the per-block kernel's plain version on every backbone block against
the JAX package's ``_fused_backbone`` with its Pallas block kernel in
interpret mode, the predictor against the JAX reference path, the
block-by-block path against the chain, and the options' checks.

On the card ``chip_smoke.py`` (phase ``seg_fused_blocks``) holds the block
kernels against these plain versions at every block's serving shape.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.ops.pallas.decoder import (
    fused_mask_decode as jax_decode,
)
from mtg_card_image_segmentation_tpu.ops.pallas.fused_block import (
    fused_inverted_residual as jax_fir,
    fused_tail_chain as jax_chain,
)
from mtg_card_image_segmentation_tpu.serving import predictor as jax_pred

from mtg_card_image_segmentation_tpu_torch.compression.slim import (
    expansion_channel_prune,
    slim_seg_state,
)
from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.models.layers import InvertedResidual
from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import (
    BlockWeights,
    kernel_takes,
)
from mtg_card_image_segmentation_tpu_torch.parallel import make_mesh
from mtg_card_image_segmentation_tpu_torch.serving import predictor as port_pred
from mtg_card_image_segmentation_tpu_torch.serving.predictor import (
    FUSED_BLOCKS,
    SegPredictor,
    kernel_block_ids,
)
from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax, init_flax_like

torch.set_num_threads(2)

H, W, B = 64, 48, 2
ALL = tuple(range(15))


@pytest.fixture(scope="module")
def weights():
    return init_flax_like(0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).integers(0, 256, (B, H, W, 3), np.uint8)


def _jax_reference(params, stats, h, w, imgs):
    return np.asarray(jax_pred.SegPredictor(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats), h, w,
        use_pallas=False, dtype=jnp.float32, auto_layout=False).predict(imgs))


def test_every_block_through_the_kernel_matches_jax_fused_backbone(weights, monkeypatch):
    """128x128 b2, float32 activations between blocks, every block in
    ``fused_blocks``: the port's ``_fused_backbone`` (the block kernel's
    plain version on all 15 blocks) against the JAX ``_fused_backbone`` with
    ``fused_ids=range(15)``, whose per-block Pallas kernel runs in interpret
    mode (every map width, 64/32/16/8, is one the JAX kernel tiles; a block
    it refused would run as its module there). Both taps within 0.05, the
    JAX package's own tolerance for this kernel
    (tests/test_pallas_fused_block.py:58): the two round to bf16 at the same
    points and sum in other orders."""
    monkeypatch.setattr(jax_pred, "fused_inverted_residual",
                        functools.partial(jax_fir, interpret=True))
    folded = port_pred._fold_normalize_into_stem(fold_batch_norm(*weights))
    imgs = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3), np.uint8)
    x = imgs.astype(np.float32) - 255.0 * port_pred._IMAGENET_MEAN
    jt = jax.tree.map(jnp.asarray, folded)
    want = jax_pred._fused_backbone(jt["backbone"], jnp.asarray(x), jnp.float32,
                                    fused_ids=ALL)
    model = from_flax(folded, None, dtype=torch.float32)
    bb = model.backbone
    blocks = {i: BlockWeights.from_module(bb.block(i)) for i in kernel_block_ids(bb, ALL)}
    assert tuple(blocks) == ALL
    with torch.no_grad():
        got = port_pred._fused_backbone(bb, torch.from_numpy(x), blocks=blocks)
    for tap, shape in (("low", (2, 16, 16, 40)), ("high", (2, 8, 8, 960))):
        assert tuple(got[tap].shape) == shape == want[tap].shape
        np.testing.assert_allclose(got[tap].numpy(), np.asarray(want[tap]),
                                   rtol=0.05, atol=0.05)


@pytest.mark.parametrize("hw,seed", [((64, 48), 1), ((320, 240), 4)])
def test_all_blocks_predictor_matches_jax_reference(weights, hw, seed):
    """``fused_blocks=range(15)`` in fp32 (the block kernels' plain versions
    on every block, bf16 products inside each block as the TPU kernel
    rounds) against the JAX reference path, b2: mask agreement >= 0.999,
    the repo's deployment gate (serving/predictor.py:403)."""
    h, w = hw
    imgs = np.random.default_rng(seed).integers(0, 256, (B, h, w, 3), np.uint8)
    theirs = _jax_reference(*weights, h, w, imgs)
    pred = SegPredictor(*weights, h, w, dtype=torch.float32, device="cpu", fused_blocks=ALL)
    assert pred.kernel_blocks == ALL
    ours = pred.predict(imgs)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == (B, h, w)
    assert (ours.numpy() == theirs).mean() >= 0.999


def _bf16_masks(weights, size, seed):
    """uint8 images (b2, ``size`` x ``size``, numpy seed ``seed``) through
    both packages' bf16 kernel paths, ``fused_blocks=range(15)`` and the
    default, and through both float32 reference paths. The JAX Pallas
    kernels (the block kernel, the tail chain, the mask decode) run in
    interpret mode."""
    params, stats = weights
    imgs = np.random.default_rng(seed).integers(0, 256, (2, size, size, 3), np.uint8)
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pred, "fused_inverted_residual", functools.partial(jax_fir, interpret=True))
        mp.setattr(jax_pred, "fused_tail_chain", functools.partial(jax_chain, interpret=True))
        mp.setattr(jax_pred, "fused_mask_decode", functools.partial(jax_decode, interpret=True))
        jax_masks = {name: np.asarray(jax_pred.SegPredictor(
            jp, js, size, size, dtype=jnp.bfloat16, auto_layout=False, **kw).predict(imgs))
            for name, kw in (("all", {"fused_blocks": ALL}), ("default", {}))}
    jax_masks["fp32"] = _jax_reference(params, stats, size, size, imgs)
    port = {name: SegPredictor(params, stats, size, size, device="cpu", **kw).predict(imgs).numpy()
            for name, kw in (("all", {"fused_blocks": ALL}), ("default", {}),
                             ("fp32", {"use_kernels": False, "dtype": torch.float32}))}
    return jax_masks, port


def _agree(a, b):
    return float((a == b).mean())


def test_bf16_all_blocks_masks_match_the_jax_kernel_path(weights):
    """128x128 b2 (the images of the block-by-block test above), bf16: the
    port's ``fused_blocks=range(15)`` masks against the JAX package's
    ``fused_blocks=range(15)`` masks, mask agreement >= 0.999, the repo's
    deployment gate (serving/predictor.py:403). Read 0.99960 on the CPU.
    The same images give the option-vs-default pairs 0.99933 (JAX) and
    0.99902 (port), held here at chip_smoke's floor for that pair (0.99)."""
    jax_masks, port = _bf16_masks(weights, 128, 2)
    assert _agree(port["all"], jax_masks["all"]) >= 0.999
    assert _agree(port["default"], jax_masks["default"]) >= 0.999
    for name, masks in (("jax", jax_masks), ("port", port)):
        assert _agree(masks["all"], masks["default"]) >= 0.99, name


def test_bf16_all_blocks_vs_default_gap_is_the_reference_own(weights):
    """512x512 b2, the card's serving size, bf16. The ground of chip_smoke's
    0.99 floor for ``fused_blocks=range(15)`` against the default path
    (phase ``seg_fused_blocks``, which reads 0.99861 at 512x512 b128 on the
    card): the JAX package's own pair misses 0.999 on these images (read
    0.99874), so a 0.999 gate on that pair fails the reference too. The
    port's pair reads 0.99864. Each bf16 path of either package lies
    0.9983-0.9986 from the float32 reference path (the two packages'
    float32 paths agree exactly), within the JAX package's own bf16-vs-fp32
    agreement of 0.998; the two packages' bf16 paths agree at 0.99882
    (``range(15)``) and 0.99866 (default): both packages round bf16 at the
    same points, but in other conv libraries."""
    jax_masks, port = _bf16_masks(weights, 512, 2)
    assert _agree(port["fp32"], jax_masks["fp32"]) == 1.0
    jax_pair = _agree(jax_masks["all"], jax_masks["default"])
    assert 0.99 <= jax_pair < 0.999
    assert _agree(port["all"], port["default"]) >= 0.99
    for name, masks in (("jax", jax_masks), ("port", port)):
        for path in ("all", "default"):
            assert _agree(masks[path], jax_masks["fp32"]) >= 0.998, (name, path)


@pytest.mark.parametrize("kw,per_block,chains", [
    ({}, 0, 1),                                  # the default: the tail chain
    ({"fused_chain": False}, 3, 0),              # MTG_FUSED_CHAIN=0: blocks 12-14 one by one
    ({"fused_blocks": ALL}, 15, 0),
    ({"fused_blocks": (1, 6, 13)}, 3, 0),
    ({"fused_blocks": (14, 13, 12)}, 3, 0),      # not the chain's tuple, as in JAX
])
def test_block_by_block_path_calls(weights, images, monkeypatch, kw, per_block, chains):
    """Which kernel wrappers one bf16 ``predict`` calls: the chain only for
    exactly blocks 12-14 with ``fused_chain``, else one per-block call per
    listed block; and the masks agree with the chain's >= 0.999."""
    calls = {"block": [], "chain": 0}
    block, chain = port_pred.fused_inverted_residual, port_pred.fused_tail_chain

    def count_block(x, bw, *a):
        calls["block"].append(bw)
        return block(x, bw, *a)

    def count_chain(*a, **k):
        calls["chain"] += 1
        return chain(*a, **k)

    base = SegPredictor(*weights, H, W, device="cpu").predict(images)
    monkeypatch.setattr(port_pred, "fused_inverted_residual", count_block)
    monkeypatch.setattr(port_pred, "fused_tail_chain", count_chain)
    pred = SegPredictor(*weights, H, W, device="cpu", **kw)
    masks = pred.predict(images)
    assert calls["chain"] == chains and len(calls["block"]) == per_block
    assert (pred._tail is not None) == bool(chains)
    assert pred.kernel_blocks == (FUSED_BLOCKS if chains else
                                  tuple(sorted(kw.get("fused_blocks", FUSED_BLOCKS))))
    assert [bw.cexp for bw in calls["block"]] == [
        pred.model.backbone.block(i).expanded for i in pred.kernel_blocks if not chains]
    assert (masks == base).float().mean() >= 0.999


def test_fused_blocks_options_are_checked(weights):
    """Block ids outside 0-14 raise; non-default ``fused_blocks`` and
    ``fused_chain=False`` are options of ``use_kernels=True``; the reference
    path runs no kernel block."""
    for bad in ((15,), (-1, 3)):
        with pytest.raises(ValueError, match="block ids 0-14"):
            SegPredictor(*weights, H, W, device="cpu", fused_blocks=bad)
    for kw in ({"fused_blocks": ALL}, {"fused_chain": False}, {"fused_blocks": ()}):
        with pytest.raises(ValueError, match="use_kernels"):
            SegPredictor(*weights, H, W, device="cpu", use_kernels=False, **kw)
    ref = SegPredictor(*weights, H, W, device="cpu", use_kernels=False)
    assert ref.kernel_blocks == () and ref.fused_blocks == FUSED_BLOCKS
    none = SegPredictor(*weights, H, W, device="cpu", fused_blocks=())
    assert none.kernel_blocks == () and none._blocks == {} and none._tail is None


def test_a_block_the_kernel_cannot_take_runs_as_its_module():
    """A block without an expand conv whose width is not a multiple of 8 is
    left out of ``kernel_blocks`` from its weights' shapes (its
    ``BlockWeights`` would raise), and ``_fused_backbone`` runs it as its
    module; a block of width 16 without an expand, or of any width with one,
    takes the kernel."""
    odd = InvertedResidual(12, 12, 16, 3, 1, fold_bn=True, dtype=torch.float32)
    even = InvertedResidual(16, 16, 16, 3, 1, fold_bn=True, dtype=torch.float32)
    slim = InvertedResidual(16, 471, 16, 3, 1, fold_bn=True, dtype=torch.float32)
    assert not kernel_takes(odd) and kernel_takes(even) and kernel_takes(slim)
    with pytest.raises(ValueError, match="multiple of 8"):
        BlockWeights.from_module(odd)

    class Stub:
        def block(self, i):
            return (odd, even, slim)[i]

    assert kernel_block_ids(Stub(), (2, 0, 1)) == (1, 2)


def test_kernel_blocks_on_slim_and_int8_weights(weights, images):
    """Widths come from the weights: a slim tree (expansion pruning 0.3,
    block 12 at 471 channels, widened to 472 in its kernel weights) and int8
    weights (the dequantized weights) take every block to the kernel; fp32
    masks agree >= 0.999 with the same tree's reference path."""
    pruned, _ = expansion_channel_prune(weights[0], 0.3)
    sp, ss, overrides = slim_seg_state(pruned, weights[1])
    slim = SegPredictor(sp, ss, H, W, dtype=torch.float32, device="cpu", fused_blocks=ALL)
    assert slim.kernel_blocks == ALL
    assert overrides[12] == 471 and slim._blocks[12].cexp == 472
    ref = SegPredictor(sp, ss, H, W, dtype=torch.float32, device="cpu", use_kernels=False)
    assert slim.mask_agreement(ref, images) >= 0.999
    q = SegPredictor(*weights, H, W, dtype=torch.float32, device="cpu", quantize="int8",
                     fused_blocks=ALL)
    dense = SegPredictor(*weights, H, W, dtype=torch.float32, device="cpu", fused_blocks=ALL)
    assert q.kernel_blocks == ALL
    # the int8 path's kernel weights are its dequantized weights, not the dense ones
    assert torch.equal(q._blocks[13].proj_w,
                       BlockWeights.from_module(q.model.backbone.block(13)).proj_w)
    assert not torch.equal(q._blocks[13].proj_w, dense._blocks[13].proj_w)
    qref = SegPredictor(*weights, H, W, dtype=torch.float32, device="cpu", quantize="int8",
                        use_kernels=False)
    assert q.mask_agreement(qref, images) >= 0.999


def test_mesh_replicas_carry_the_options(weights, images):
    """Batch-split serving over a two-device CPU mesh: the replica gets
    ``fused_blocks`` and ``fused_chain`` by name, runs the same kernel
    blocks, and the split masks equal one predictor's."""
    kw = {"fused_blocks": (1, 6, 13), "fused_chain": False}
    split = SegPredictor(*weights, H, W, mesh=make_mesh(devices=["cpu", "cpu"]), **kw)
    assert len(split._replicas) == 2
    for r in split._replicas:
        assert (r.fused_blocks, r.fused_chain, r.kernel_blocks) == ((1, 6, 13), False,
                                                                    (1, 6, 13))
    one = SegPredictor(*weights, H, W, device="cpu", **kw)
    assert torch.equal(split.predict(images), one.predict(images))
