"""The port's kernel modules (plain versions, CPU) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs.

On the CPU every wrapper takes its plain version; the CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.ops.pallas import fused_mask_decode as jax_decode
from mtg_card_image_segmentation_tpu.ops.pallas.decoder import (
    _interp_matrix as jax_interp_matrix,
)
from mtg_card_image_segmentation_tpu.ops.pallas.fused_block import (
    fused_inverted_residual as jax_fir,
    fused_tail_chain as jax_chain,
)
from mtg_card_image_segmentation_tpu.ops.resize import bilinear_resize as jax_resize

from mtg_card_image_segmentation_tpu_torch.models.layers import make_divisible
from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
from mtg_card_image_segmentation_tpu_torch.ops.kernels.decoder import (
    fused_mask_decode,
    fused_mask_decode_plain,
)
from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import (
    BlockWeights,
    fused_inverted_residual,
    fused_tail_chain,
)
from mtg_card_image_segmentation_tpu_torch.ops.resize import (
    _interp_matrix,
    _interp_taps,
    bilinear_resize,
)

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# mask decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "b,h,w,out_h,out_w,seed",
    [(2, 40, 30, 320, 240, 3), (1, 13, 9, 100, 75, 4), (2, 8, 8, 64, 64, 5)],
)
def test_mask_decode_matches_jax_kernel_and_argmax(b, h, w, out_h, out_w, seed):
    """Exact uint8 equality, the JAX package's own bar
    (tests/test_pallas.py:48-65): both sides threshold the same bilinear
    lerps of the same float32 scores."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    scores = logits[..., 1] - logits[..., 0]
    ours = fused_mask_decode(torch.from_numpy(scores), out_h, out_w).numpy()
    theirs = np.asarray(jax_decode(jnp.asarray(scores), out_h, out_w, interpret=True))
    full = jax_resize(jnp.asarray(logits), out_h, out_w)
    argmax = np.asarray(jnp.argmax(full, axis=-1)).astype(np.uint8)
    assert ours.dtype == np.uint8 and ours.shape == (b, out_h, out_w)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, argmax)


@pytest.mark.parametrize("n_in,n_out", [(64, 512), (13, 100), (9, 75), (4, 8), (1, 5)])
def test_interp_taps_reproduce_interp_matrix(n_in, n_out):
    """The kernel's two taps per row are the nonzeros of _interp_matrix,
    which is a copy of the JAX package's (exact equality)."""
    m = _interp_matrix(n_in, n_out)
    np.testing.assert_array_equal(m, jax_interp_matrix(n_in, n_out))
    lo, hi, w0, w1 = _interp_taps(n_in, n_out)
    dense = np.zeros_like(m)
    np.add.at(dense, (np.arange(n_out), lo), w0)
    np.add.at(dense, (np.arange(n_out), hi), w1)
    np.testing.assert_array_equal(dense, m)


def test_bilinear_resize_matches_jax():
    """Port resize vs the JAX resize, fp32. Same float32 lerp formula; XLA
    may contract ``a + (b - a) * w`` into an FMA, one float32 rounding
    apart, hence 1e-5 at values of order 1."""
    x = np.random.default_rng(6).standard_normal((2, 13, 9, 3)).astype(np.float32)
    ours = bilinear_resize(torch.from_numpy(x), 40, 30).numpy()
    theirs = np.asarray(jax_resize(jnp.asarray(x), 40, 30))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# inverted residual + tail chain
# --------------------------------------------------------------------------


def _folded_block(cin, exp, cout, k, se, seed=0, h=16, w=16):
    """A folded block subtree (HWIO kernels + biases, the layout
    export.fold_bn produces) and an NHWC input, drawn from a numpy seed:
    LeCun-normal kernels, small nonzero biases."""
    rng = np.random.default_rng(seed)

    def conv(kh, ci, co, fan_in):
        return {"kernel": (rng.standard_normal((kh, kh, ci, co)) / np.sqrt(fan_in)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(co)).astype(np.float32)}

    p = {}
    if exp != cin:
        p["expand"] = {"conv": conv(1, cin, exp, cin)}
    p["depthwise"] = {"conv": conv(k, 1, exp, k * k)}
    if se:
        sq = make_divisible(exp // 4, 8)
        p["se"] = {"fc1": conv(1, exp, sq, exp), "fc2": conv(1, sq, exp, sq)}
    p["project"] = {"conv": conv(1, exp, cout, exp)}
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    return x, p


@pytest.mark.parametrize(
    "cin,exp,cout,k,stride,se,act,residual,dilation",
    [
        (16, 16, 16, 3, 1, False, "relu", True, 1),    # block0 (no expand)
        (16, 64, 24, 3, 2, False, "relu", False, 1),   # block1 (stride 2)
        (24, 72, 24, 3, 1, False, "relu", True, 1),    # block2
        (24, 72, 40, 5, 2, True, "relu", False, 1),    # block3 (k5, SE, s2)
        (40, 120, 40, 5, 1, True, "relu", True, 1),    # block4
        (80, 184, 80, 3, 1, False, "hardswish", True, 1),
        (24, 72, 24, 5, 1, True, "hardswish", True, 2),  # dilated tail shape
    ],
)
def test_fused_inverted_residual_matches_jax_kernel(cin, exp, cout, k, stride,
                                                    se, act, residual, dilation):
    """Plain version vs the Pallas kernel (interpret). Tolerance 0.05, the
    JAX package's own for this kernel (tests/test_pallas_fused_block.py:58):
    both round to bf16 at the same points, but sums run in another order,
    so a bf16 rounding can land one ulp apart."""
    x, folded = _folded_block(cin, exp, cout, k, se)
    theirs = np.asarray(jax_fir(jnp.asarray(x), folded, kernel_size=k, stride=stride, act=act,
                                residual=residual, dilation=dilation,
                                interpret=True))
    ours = fused_inverted_residual(torch.from_numpy(x), folded,
                                   kernel_size=k, stride=stride, act=act,
                                   residual=residual, dilation=dilation)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0.05, atol=0.05)


def _chain_params(specs, h, w):
    blocks = [_folded_block(cin, exp, cout, 5, True, seed=si, h=h, w=w)
              for si, (cin, exp, cout) in enumerate(specs)]
    return blocks[0][0], tuple(p for _, p in blocks)


@pytest.mark.parametrize(
    "specs,hw",
    [
        ([(24, 64, 40), (40, 96, 40), (40, 96, 40)], 8),  # narrow stand-ins
        ([(112, 672, 160), (160, 960, 160), (160, 960, 160)], 8),  # full widths
    ],
)
def test_fused_tail_chain_matches_jax_kernel(specs, hw):
    """Plain chain vs the Pallas chain (interpret): float32 between blocks
    on both sides. Tolerance 0.06, the JAX package's own
    (tests/test_pallas_fused_block.py:156)."""
    x, params = _chain_params(specs, hw, hw)
    theirs = np.asarray(jax_chain(jnp.asarray(x), params, kernel_size=5, act="hardswish",
                                  dilation=2, interpret=True))
    ours = fused_tail_chain(torch.from_numpy(x), params,
                            kernel_size=5, act="hardswish", dilation=2)
    assert tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0.06, atol=0.06)


def test_block_weights_from_module_equal_from_flax():
    """The kernels' weight layouts are the same whether built from the Flax
    tree or from the port's module loaded through the bridge (exact)."""
    from mtg_card_image_segmentation_tpu_torch.models.layers import InvertedResidual
    from mtg_card_image_segmentation_tpu_torch.utils.params import flax_to_state_dict

    _, folded = _folded_block(24, 72, 40, 5, True)
    m = InvertedResidual(24, 72, 40, 5, 2, use_se=True, act="relu", fold_bn=True)
    m.load_state_dict(flax_to_state_dict(folded))
    a, b = BlockWeights.from_flax(folded, 5), BlockWeights.from_module(m)
    for name in ("exp_w", "exp_b", "dw_w", "dw_b", "se1_w", "se1_b", "se2_w",
                 "se2_b", "proj_w", "proj_b"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor goes to the plain version: results equal the plain
    functions and no kernel launch is counted."""
    _build.reset_launches()
    s = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 8, 8)).astype(np.float32))
    assert torch.equal(fused_mask_decode(s, 32, 32), fused_mask_decode_plain(s, 32, 32))
    x, folded = _folded_block(16, 64, 24, 3, False)
    fused_inverted_residual(torch.from_numpy(x), folded, 3, 2, "relu")
    assert _build.LAUNCHES == {}


def test_kernel_path_refuses_unsupported_device_or_dtype():
    """The kernel path never falls back: a tensor that is neither CPU nor a
    bf16 CUDA tensor raises instead of running elsewhere."""
    _, folded = _folded_block(16, 64, 24, 3, False)
    meta = torch.empty((2, 16, 16, 16), device="meta")
    with pytest.raises(ValueError):
        fused_inverted_residual(meta, folded, 3, 2, "relu")
    with pytest.raises(ValueError):
        fused_mask_decode(torch.empty((1, 4, 4), device="meta"), 8, 8)
