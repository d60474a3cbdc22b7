"""The port's kernel modules (plain versions, CPU) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs.

On the CPU every wrapper takes its plain version; the CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.data.preprocess import preprocess_batch as jax_preprocess
from mtg_card_image_segmentation_tpu.ops.pallas import fused_mask_decode as jax_decode
from mtg_card_image_segmentation_tpu.ops.pallas import (
    fused_head_decode as jax_head_decode,
    fused_normalize as jax_normalize,
    fused_stem as jax_stem,
    upsample2x_add as jax_upsample2x_add,
)
from mtg_card_image_segmentation_tpu.ops.pallas.decoder import (
    _interp_matrix as jax_interp_matrix,
)
from mtg_card_image_segmentation_tpu.ops.pallas.fused_block import (
    fused_inverted_residual as jax_fir,
    fused_tail_chain as jax_chain,
)
from mtg_card_image_segmentation_tpu.ops.resize import bilinear_resize as jax_resize
from mtg_card_image_segmentation_tpu.ops.resize import upsample_add as jax_upsample_add

from mtg_card_image_segmentation_tpu_torch.models.layers import make_divisible
from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
from mtg_card_image_segmentation_tpu_torch.ops.kernels.decoder import (
    fused_head_decode,
    fused_head_decode_plain,
    fused_mask_decode,
    fused_mask_decode_plain,
    tree_order_case,
    upsample2x_add,
    upsample2x_add_plain,
)
from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import (
    BlockWeights,
    fused_inverted_residual,
    fused_tail_chain,
)
from mtg_card_image_segmentation_tpu_torch.ops.kernels.preprocess import (
    fused_normalize,
    fused_normalize_plain,
)
from mtg_card_image_segmentation_tpu_torch.ops.kernels.stem import fused_stem, fused_stem_plain
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


@pytest.mark.parametrize("high_hw,low_hw", [((8, 6), (16, 12)), ((5, 7), (12, 9))])
def test_upsample_add_matches_jax(high_hw, low_hw):
    """``ops.upsample_add`` (exported as the JAX package's ``ops`` exports
    it) against the JAX ``upsample_add``, fp32, at a 2x and a non-2x
    ratio: within 1e-6 at values of order 1."""
    from mtg_card_image_segmentation_tpu_torch.ops import upsample_add

    rng = np.random.default_rng(7)
    high = rng.standard_normal((2, *high_hw, 5)).astype(np.float32)
    low = rng.standard_normal((2, *low_hw, 5)).astype(np.float32)
    ours = upsample_add(torch.from_numpy(high), torch.from_numpy(low))
    theirs = np.asarray(jax_upsample_add(jnp.asarray(high), jnp.asarray(low)))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6)


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


# --------------------------------------------------------------------------
# normalize, upsample2x_add, head decode, stem (shapes of tests/test_pallas.py)
# --------------------------------------------------------------------------


def test_fused_normalize_matches_jax_kernel_and_reference():
    """float32: 1e-5 against the Pallas kernel (interpret) and against the
    JAX package's preprocess_batch, its own bar (tests/test_pallas.py:22-29):
    x*scale + shift and (x/255 - mean)/std round differently."""
    img = np.random.default_rng(0).integers(0, 256, (2, 40, 30, 3), dtype=np.uint8)
    ours = fused_normalize(torch.from_numpy(img))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == img.shape
    kernel = np.asarray(jax_normalize(jnp.asarray(img), interpret=True))
    ref = np.asarray(jax_preprocess(jnp.asarray(img), None, 40, 30, normalize=True))
    np.testing.assert_allclose(ours.numpy(), kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_fused_normalize_bf16_output():
    """bfloat16 out (tests/test_pallas.py:32-36): the dtype, and within one
    bf16 ulp (2^-6 at |x| < 2.7) of the Pallas kernel's bf16 output."""
    img = np.random.default_rng(1).integers(0, 256, (1, 8, 16, 3), dtype=np.uint8)
    ours = fused_normalize(torch.from_numpy(img), out_dtype=torch.bfloat16)
    theirs = jax_normalize(jnp.asarray(img), out_dtype=jnp.bfloat16, interpret=True)
    assert ours.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
    d = np.abs(ours.float().numpy() - np.asarray(theirs.astype(jnp.float32)))
    assert d.max() <= 2.0 ** -6


def test_upsample2x_add_matches_jax_kernel_and_reference():
    """1e-5 against the Pallas kernel (interpret) and the JAX upsample_add
    (tests/test_pallas.py:39-45); the output takes ``low``'s dtype."""
    rng = np.random.default_rng(2)
    high = rng.standard_normal((2, 20, 15, 128)).astype(np.float32)
    low = rng.standard_normal((2, 40, 30, 128)).astype(np.float32)
    ours = upsample2x_add(torch.from_numpy(high), torch.from_numpy(low))
    assert ours.dtype == torch.float32
    kernel = np.asarray(jax_upsample2x_add(jnp.asarray(high), jnp.asarray(low), interpret=True))
    ref = np.asarray(jax_upsample_add(jnp.asarray(high), jnp.asarray(low)))
    np.testing.assert_allclose(ours.numpy(), kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    ours16 = upsample2x_add(torch.from_numpy(high).bfloat16(), torch.from_numpy(low).bfloat16())
    assert ours16.dtype == torch.bfloat16
    # bf16 inputs and output: within the inputs' rounding, 3 * 2^-8 relative
    np.testing.assert_allclose(ours16.float().numpy(), ref, rtol=0.02, atol=0.05)


def test_fused_head_decode_tree_order_case_matches_jax_kernel():
    """``tree_order_case``, whose mask depends on the order of the channel
    sums (empty in the kernels' tree order, full if -1 meets 1 first): the
    plain head decode and the Pallas kernel (interpret) on the same bf16
    inputs differ in 0 pixels, and the mask is empty."""
    x, gw, low, w_lo, bias, out_h, out_w = tree_order_case()
    ours = fused_head_decode(x, gw, low, w_lo, bias, out_h, out_w)
    kernel = np.asarray(jax_head_decode(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                      else jnp.float32) for t in (x, gw, low, w_lo)),
        jnp.float32(bias), out_h, out_w, interpret=True))
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == kernel.shape == (2, out_h, out_w)
    assert int((ours.numpy() != kernel).sum()) == 0
    assert not kernel.any()


def test_fused_head_decode_matches_jax_kernel_and_composed_pipeline():
    """Exact uint8 equality with the Pallas kernel (interpret) and with the
    pipeline composed from independent pieces, the JAX package's own bar
    (tests/test_pallas.py:68-90)."""
    rng = np.random.default_rng(5)
    b, h16, w16, c, cl = 2, 10, 8, 24, 12
    h8, w8 = 2 * h16, 2 * w16
    x = rng.standard_normal((b, h16, w16, c)).astype(np.float32)
    gw = rng.standard_normal((b, c)).astype(np.float32)
    low = rng.standard_normal((b, h8, w8, cl)).astype(np.float32)
    w_lo = rng.standard_normal(cl).astype(np.float32)
    ours = fused_head_decode(*(torch.from_numpy(a) for a in (x, gw, low, w_lo)),
                             0.17, 160, 128)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == (b, 160, 128)
    kernel = np.asarray(jax_head_decode(jnp.asarray(x), jnp.asarray(gw), jnp.asarray(low),
                                        jnp.asarray(w_lo), jnp.float32(0.17), 160, 128,
                                        interpret=True))
    hs = jnp.einsum("bhwc,bc->bhw", jnp.asarray(x), jnp.asarray(gw))
    hs = jax_resize(hs[..., None], h8, w8)[..., 0]
    score = hs + jnp.einsum("bhwc,c->bhw", jnp.asarray(low), jnp.asarray(w_lo)) + 0.17
    ref = (np.asarray(jax_resize(score[..., None], 160, 128)[..., 0]) > 0).astype(np.uint8)
    np.testing.assert_array_equal(ours.numpy(), kernel)
    np.testing.assert_array_equal(ours.numpy(), ref)


def _stem_case(n, h, w, seed, bias_scale=0.1, center=None):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    kernel = (rng.standard_normal((3, 3, 3, 16)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((16,)) * bias_scale).astype(np.float32)
    if center is None:
        center = (255.0 * np.array([0.485, 0.456, 0.406])).astype(np.float32)
    return imgs, kernel, bias, center


@pytest.mark.parametrize("hw", [(64, 64), (40, 24)])
def test_fused_stem_matches_jax_kernel_and_conv(hw):
    """float32 out, against the Pallas kernel (interpret) and against a
    conv reference in bf16: rtol 0.02 / atol 1.0 / mean < 0.1, the JAX
    package's own bars (tests/test_pallas.py:105-135): one bf16 ulp at the
    activation magnitude (~160), from the bf16 centering and the order of
    the sums."""
    h, w = hw
    imgs, kernel, bias, center = _stem_case(3, h, w, 5)
    ours = fused_stem(*(torch.from_numpy(a) for a in (imgs, kernel, bias, center)),
                      out_dtype=torch.float32)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (3, h // 2, w // 2, 16)
    theirs = np.asarray(jax_stem(jnp.asarray(imgs), jnp.asarray(kernel), jnp.asarray(bias),
                                 jnp.asarray(center), out_dtype=jnp.float32, interpret=True))
    x = torch.from_numpy(imgs).float() - torch.from_numpy(center)
    y = torch.nn.functional.conv2d(
        x.bfloat16().permute(0, 3, 1, 2), torch.from_numpy(kernel).bfloat16().permute(3, 2, 0, 1),
        None, stride=2, padding=1) + torch.from_numpy(bias).bfloat16()[:, None, None]
    yf = y.float().permute(0, 2, 3, 1)
    conv_ref = (yf * (torch.clamp(yf + 3.0, 0.0, 6.0) / 6.0)).numpy()
    for ref in (theirs, conv_ref):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0.02, atol=1.0)
        assert float(np.abs(ours.numpy() - ref).mean()) < 0.1
    out16 = fused_stem(*(torch.from_numpy(a) for a in (imgs, kernel, bias, center)))
    assert out16.dtype == torch.bfloat16


def test_fused_stem_batch_split_invariance():
    """Each image's result does not depend on what else is in the batch
    (tests/test_pallas.py:138-155): exact."""
    imgs, kernel, bias, center = _stem_case(4, 32, 32, 6, bias_scale=0.0,
                                            center=np.full((3,), 120.0, np.float32))
    k, b, c = (torch.from_numpy(a) for a in (kernel, bias, center))
    whole = fused_stem_plain(torch.from_numpy(imgs), k, b, c, torch.float32)
    for bt in (1, 2):
        parts = [fused_stem_plain(torch.from_numpy(imgs[i:i + bt]), k, b, c, torch.float32)
                 for i in range(0, 4, bt)]
        assert torch.equal(torch.cat(parts), whole)


def test_new_wrappers_take_plain_version_on_cpu():
    """CPU tensors go to the plain versions: equal results, no launch
    counted."""
    _build.reset_launches()
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.integers(0, 256, (1, 8, 8, 3), dtype=np.uint8))
    assert torch.equal(fused_normalize(img, torch.bfloat16),
                       fused_normalize_plain(img, torch.bfloat16))
    high = torch.from_numpy(rng.standard_normal((1, 4, 4, 8)).astype(np.float32))
    low = torch.from_numpy(rng.standard_normal((1, 8, 8, 8)).astype(np.float32))
    assert torch.equal(upsample2x_add(high, low), upsample2x_add_plain(high, low))
    gw = torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32))
    w_lo = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    assert torch.equal(fused_head_decode(high, gw, low, w_lo, 0.1, 32, 32),
                       fused_head_decode_plain(high, gw, low, w_lo, 0.1, 32, 32))
    imgs, kernel, bias, center = (torch.from_numpy(a) for a in _stem_case(1, 8, 8, 9))
    assert torch.equal(fused_stem(imgs, kernel, bias, center),
                       fused_stem_plain(imgs, kernel, bias, center))
    assert _build.LAUNCHES == {}


@pytest.mark.parametrize("case", ["normalize_dtype", "normalize_rank", "normalize_out",
                                  "stem_dtype", "stem_size", "stem_kernel",
                                  "head_shapes", "upsample_shapes"])
def test_new_wrappers_reject_wrong_inputs(case):
    """A wrong dtype, rank or shape raises; nothing is converted on the
    quiet."""
    img = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    kernel, bias, center = torch.zeros(3, 3, 3, 16), torch.zeros(16), torch.zeros(3)
    with pytest.raises(ValueError):
        if case == "normalize_dtype":
            fused_normalize(img.float())
        elif case == "normalize_rank":
            fused_normalize(img[0])
        elif case == "normalize_out":
            fused_normalize(img, out_dtype=torch.float16)
        elif case == "stem_dtype":
            fused_stem(img.float(), kernel, bias, center)
        elif case == "stem_size":
            fused_stem(torch.zeros((1, 12, 8, 3), dtype=torch.uint8), kernel, bias, center)
        elif case == "stem_kernel":
            fused_stem(img, torch.zeros(3, 3, 3, 8), bias, center)
        elif case == "head_shapes":
            fused_head_decode(torch.zeros(1, 4, 4, 8), torch.zeros(1, 7), torch.zeros(1, 8, 8, 8),
                              torch.zeros(8), 0.0, 32, 32)
        else:
            upsample2x_add(torch.zeros(1, 4, 4, 8), torch.zeros(1, 8, 7, 8))


@pytest.mark.parametrize("case", ["normalize", "stem", "head_decode", "upsample"])
def test_new_kernel_paths_refuse_other_devices(case):
    """The kernel paths never fall back: a tensor that is neither a CPU nor
    a CUDA tensor raises instead of running elsewhere."""
    with pytest.raises(ValueError):
        if case == "normalize":
            fused_normalize(torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta"))
        elif case == "stem":
            fused_stem(torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta"),
                       torch.zeros(3, 3, 3, 16), torch.zeros(16), torch.zeros(3))
        elif case == "head_decode":
            meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
            fused_head_decode(meta(1, 4, 4, 8), meta(1, 8), meta(1, 8, 8, 8), meta(8),
                              0.0, 32, 32)
        else:
            upsample2x_add(torch.empty((1, 4, 4, 8), device="meta"),
                           torch.empty((1, 8, 8, 8), device="meta"))


# --------------------------------------------------------------------------
# stencil floor (tools/vpu_stencil_floor.py)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpu_stencil_tool():
    """The TPU tool's module, loaded from its file, with its shape constants
    set to a small size for the interpreter (the file itself is untouched)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "vpu_stencil_floor.py"
    spec = importlib.util.spec_from_file_location("_vpu_stencil_floor_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.BT, mod.H, mod.W, mod.CIN, mod.CEXP, mod.B = 2, 8, 8, 16, 64, 4
    return mod


@pytest.mark.parametrize("mode", ["pass", "arith", "full"])
def test_stencil_floor_plain_matches_tpu_kernel_body(tpu_stencil_tool, mode):
    """stencil_floor (plain version on the CPU) against the TPU kernel's
    body (tools/vpu_stencil_floor.make_kernel) run by the Pallas
    interpreter, same numpy inputs. 1e-5 at outputs of order 5e-2: both
    round y and every term to bf16 at the same places; the float32 sums are
    taken in another order, and a y that sits within float32 rounding of a
    bf16 tie may round the other way (one such flip moves a mean over 64
    channels by at most 2^-8/64 = 6e-5 at |y| < 1, so the inputs are scaled to
    keep y small and the seed is fixed)."""
    from jax.experimental import pallas as pl

    from mtg_card_image_segmentation_tpu_torch.ops.kernels.stencil_floor import (
        stencil_floor,
        stencil_floor_plain,
    )

    t = tpu_stencil_tool
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((t.B, t.H, t.W, t.CIN)) * 0.25).astype(np.float32)
    w_exp = (rng.standard_normal((t.CIN, t.CEXP)) * 0.05).astype(np.float32)
    w_dw = (rng.standard_normal((t.K * t.K, t.CEXP)) * 0.05).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    theirs = pl.pallas_call(
        t.make_kernel(mode),
        out_shape=jax.ShapeDtypeStruct((t.B, t.H, t.W, 1), jnp.float32),
        grid=(t.B // t.BT,),
        in_specs=[
            pl.BlockSpec((t.BT, t.H, t.W, t.CIN), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((t.CIN, t.CEXP), lambda i: (0, 0)),
            pl.BlockSpec((t.K * t.K, t.CEXP), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((t.BT, t.H, t.W, 1), lambda i: (i, 0, 0, 0)),
        interpret=True,
    )(xb, jnp.asarray(w_exp), jnp.asarray(w_dw))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    ours = stencil_floor(xt, torch.from_numpy(w_exp), torch.from_numpy(w_dw), mode,
                         t.K, t.DIL)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (t.B, t.H, t.W, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-5)
    # the wrapper took the plain version (CPU tensor) and launched nothing
    assert torch.equal(ours, stencil_floor_plain(
        xt, torch.from_numpy(w_exp), torch.from_numpy(w_dw), mode, t.K, t.DIL))


def test_stencil_floor_modes_differ_and_full_is_the_depthwise():
    """``full`` is the dilated depthwise of the tail block: against
    F.conv2d(groups=E, dilation=2) in float32 on the bf16-rounded y and taps
    (the per-term bf16 rounding bounds the gap: 25 terms of |y*w| <= 0.05,
    each rounded at 2^-9 relative, mean of 64 channels -> 1e-4). ``arith`` is a
    different function on purpose, ``pass`` the mean of y."""
    import torch.nn.functional as F

    from mtg_card_image_segmentation_tpu_torch.ops.kernels.stencil_floor import (
        bound_ms,
        stencil_floor,
    )

    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.standard_normal((2, 8, 16, 16)) * 0.25).astype(np.float32))
    x = x.to(torch.bfloat16)
    w_exp = torch.from_numpy((rng.standard_normal((16, 64)) * 0.05).astype(np.float32))
    w_dw = torch.from_numpy((rng.standard_normal((25, 64)) * 0.05).astype(np.float32))
    out = {m: stencil_floor(x, w_exp, w_dw, m) for m in ("pass", "arith", "full")}
    y = (x.float() @ w_exp.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    np.testing.assert_allclose(out["pass"].numpy(), y.mean(-1, keepdim=True).numpy(), atol=1e-6)
    taps = w_dw.to(torch.bfloat16).float().reshape(5, 5, 64).permute(2, 0, 1)[:, None]
    conv = F.conv2d(y.permute(0, 3, 1, 2), taps, padding=4, dilation=2, groups=64)
    want = conv.permute(0, 2, 3, 1).mean(-1, keepdim=True)
    np.testing.assert_allclose(out["full"].numpy(), want.numpy(), atol=1e-4)
    assert float((out["full"] - out["arith"]).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="unknown mode"):
        stencil_floor(x, w_exp, w_dw, "half")
    # the bound at the tool's shape: operations, and `pass` below the others
    full, by = bound_ms((128, 32, 32, 160), 960, "full")
    assert by == "operations" and full > bound_ms((128, 32, 32, 160), 960, "pass")[0]
    # per expanded value 25 packed bf16 products (134 TFLOP/s), then 24 adds
    # and the add into the channel sum in float32 (67 TFLOP/s)
    assert full == pytest.approx(128 * 1024 * 960 * (25 / 134e12 + 25 / 67e12) * 1e3,
                                 rel=1e-12)
    # the products at the float32 rate: the bound before the packed products
    assert bound_ms((128, 32, 32, 160), 960, "full", packed_products=False)[0] == pytest.approx(
        128 * 1024 * 960 * 25 * 2 / 67e12 * 1e3, rel=1e-12)


def test_stencil_tool_fails_without_a_card():
    """tools/stencil_floor_torch.py exits non-zero and prints no time where
    CUDA is absent; its inputs are the TPU tool's (same seed, shapes and
    scales), and its kernel wrapper refuses shapes the kernel does not take."""
    import subprocess
    import sys
    from pathlib import Path

    from mtg_card_image_segmentation_tpu_torch.ops.kernels.stencil_floor import _check

    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(repo / "tools" / "stencil_floor_torch.py")],
                         cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and " ms" not in out.stdout
    sys.path.insert(0, str(repo / "tools"))
    try:
        import stencil_floor_torch as tool
    finally:
        sys.path.remove(str(repo / "tools"))
    assert (tool.B, tool.H, tool.W, tool.CIN, tool.CEXP, tool.K, tool.DIL) == (
        128, 32, 32, 160, 960, 5, 2)
    rng = np.random.default_rng(0)  # the TPU tool's draws, in its order
    x = rng.standard_normal((128, 32, 32, 160))
    w_exp = rng.standard_normal((160, 960)) * 0.05
    w_dw = rng.standard_normal((25, 960)) * 0.05
    tx, tw, td = tool.make_inputs(0, "cpu")
    assert tx.dtype == torch.bfloat16 and tw.dtype == td.dtype == torch.float32
    assert torch.equal(tx, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))
    np.testing.assert_array_equal(tw.numpy(), w_exp.astype(np.float32))
    np.testing.assert_array_equal(td.numpy(), w_dw.astype(np.float32))
    with pytest.raises(ValueError, match="w_dw"):
        _check(tx[:1], tw, td[:9], "full", 5)
    with pytest.raises(ValueError, match="bfloat16"):
        _check(tx[:1].float(), tw, td, "full", 5)


# ---- stencil_floor's launch plan and its term chain, emulated -------------

STENCIL_TOOL_SHAPE = ((128, 32, 32, 160), 960, 5, 2)
# rows that fill no strip, more than one channel slice, W not a multiple of
# 16; then other dilations, kernel sizes and odd sizes
STENCIL_RAGGED = [((3, 20, 48, 64), 192, 5, 2), ((2, 13, 32, 16), 128, 5, 3),
                  ((1, 7, 16, 16), 64, 5, 1), ((2, 9, 24, 32), 64, 5, 2),
                  ((2, 12, 8, 32), 64, 3, 1)]


def test_stencil_plan_at_the_tools_shape():
    """One CTA of 512 threads per image, under the 227 KB a CTA may take
    (the y slice 128 KB, two x chunks of 128 pixels x 160 channels, the tap
    weights, one float per pixel): one CTA per SM, as the whole-image tile
    needs, and two chain strips of 4 rows per warp."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels.stencil_floor import (
        MAX_SMEM,
        stencil_plan,
    )

    shape, e, k, d = STENCIL_TOOL_SHAPE
    plan = stencil_plan(shape, e, k, d)
    assert MAX_SMEM == 227 * 1024
    assert plan["smem_bytes"] == 32 * 32 * 64 * 2 + 2 * 128 * 160 * 2 + 25 * 32 * 4 + 32 * 32 * 4
    assert plan["smem_bytes"] <= MAX_SMEM < 2 * plan["smem_bytes"]
    assert (plan["ctas"], plan["threads"], plan["ctas_per_sm"]) == (128, 512, 1)
    assert (plan["slices"], plan["chunks"], plan["col_groups"]) == (15, 8, 4)
    assert plan["tasks"] == 2 * plan["threads"] // 32
    assert plan["strip_rows"] == [list(range(r0 + r, r0 + 8, 2)) for r0 in range(0, 32, 8)
                                  for r in (0, 1)]


@pytest.mark.parametrize("shape,e,k,d", STENCIL_RAGGED)
def test_stencil_plan_covers_every_output_row(shape, e, k, d):
    """Every output row lies in exactly one chain strip (rows past the
    image only pad a last strip), every column in one group of 8, the strip
    rows step by the dilation, and the budget holds."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels.stencil_floor import (
        MAX_SMEM,
        STRIP_PAIRS,
        stencil_plan,
    )

    b, h, w, _ = shape
    plan = stencil_plan(shape, e, k, d)
    rows = [r for strip in plan["strip_rows"] for r in strip]
    assert sorted(r for r in rows if r < h) == list(range(h))
    for strip in plan["strip_rows"]:
        assert len(strip) == 2 * STRIP_PAIRS and all(
            b_ - a == d for a, b_ in zip(strip, strip[1:]))
    assert (plan["col_groups"] - 1) * 8 < w <= plan["col_groups"] * 8
    assert plan["tasks"] == len(plan["strip_rows"]) * plan["col_groups"]
    assert plan["ctas"] == b and plan["smem_bytes"] <= MAX_SMEM
    assert plan["slices"] == e // 64 and plan["chunks"] == -(-h * w // 128)


@pytest.mark.parametrize("shape,e,k,why", [
    ((1, 8, 12, 16), 64, 5, "W a multiple of 8"),
    ((1, 8, 8, 24), 64, 5, "multiple of 16"), ((1, 8, 8, 176), 64, 5, "up to 160"),
    ((1, 8, 8, 16), 96, 5, "multiple of 64"), ((1, 8, 8, 16), 64, 7, "k 3 or 5"),
    ((1, 48, 48, 160), 64, 5, "shared memory")])
def test_stencil_floor_refuses_what_the_tiling_cannot_take(shape, e, k, why):
    """Shapes the kernel's tiling does not take raise ValueError from the
    plan and from the wrapper for a tensor that is not on the CPU (checked
    on the meta device, before the device check); a shape it takes reaches
    the device check."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels.stencil_floor import (
        stencil_floor,
        stencil_plan,
    )

    with pytest.raises(ValueError, match=why):
        stencil_plan(shape, e, k, 2)
    meta = dict(device="meta")
    x = torch.empty(shape, dtype=torch.bfloat16, **meta)
    w_exp = torch.empty((shape[-1], e), dtype=torch.float32, **meta)
    w_dw = torch.empty((k * k, e), dtype=torch.float32, **meta)
    with pytest.raises(ValueError, match=why):
        stencil_floor(x, w_exp, w_dw, "full", k, 2)
    x = torch.empty((1, 8, 8, 16), dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        stencil_floor(x, torch.empty((16, 64), **meta), torch.empty((25, 64), **meta), "full")


def _word_of(col, q, t):
    """csrc/stencil_floor.cu::word_of: the y tile's word of channels 8q + 2t,
    + 1 of column ``col`` within a row (chunks XOR-swizzled by the column)."""
    return col * 32 + ((q ^ (col & 7)) << 2) + t


def _tap_pairs(k):
    """The kernel's order of the k*k taps in MMAs: two tap columns at a
    time, taps (ky, kx0 + u) numbered e = ky * ncol + u, two per MMA."""
    mmas = []
    for kx0 in range(0, k, 2):
        ncol = 2 if kx0 + 1 < k else 1
        nt = k * ncol
        for m in range((nt + 1) // 2):
            mmas.append([(e // ncol) * k + kx0 + e % ncol for e in (2 * m, 2 * m + 1) if e < nt])
    return mmas


def _emulate_stencil_kernel(x, w_exp, w_dw, mode, k, d):
    """The kernel's term chain with its own index maps: y stored into a tile
    by ``_word_of`` and read back from it, the chain strips of
    ``stencil_plan``, the window rows and columns of each pixel pair, the
    taps in ``_tap_pairs`` order; every product rounded to bf16 (the exact
    product of two bf16 values, as ``mul.rn.bf16x2``), sums in float64."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels.stencil_floor import (
        STRIP_PAIRS,
        stencil_plan,
    )

    bf = torch.bfloat16
    b, h, w, _ = x.shape
    e = w_exp.shape[1]
    plan = stencil_plan(tuple(x.shape), e, k, d)
    y = (x.float() @ w_exp.to(bf).float()).to(bf).float().numpy()
    taps = w_dw.to(bf).float().numpy()
    p = (k - 1) // 2
    g = np.arange(8)[:, None, None]
    t = np.arange(4)[None, :, None]
    q = np.arange(8)[None, None, :]
    cols = np.arange(w)[:, None, None]
    words = _word_of(cols, np.arange(8)[None, :, None], np.arange(4)[None, None, :])
    chans = 8 * np.arange(8)[None, :, None] + 2 * np.arange(4)[None, None, :]
    out = np.zeros((b, h, w))
    for img in range(b):
        for s in range(plan["slices"]):
            ys = y[img, :, :, 64 * s:64 * (s + 1)]
            tile = np.full((h, 32 * w, 2), np.nan, np.float32)
            for half in range(2):
                tile[:, words.reshape(-1), half] = ys[:, np.broadcast_to(cols, words.shape).reshape(-1),
                                                      np.broadcast_to(chans, words.shape).reshape(-1) + half]
            assert not np.isnan(tile).any()  # the map is onto: every word written once
            wt = np.stack([taps[:, 64 * s + 8 * q + 2 * t + half] for half in range(2)], -1)

            def ld(r, c):  # (8, 4, 8, 2): lane (g, t), group q; zero outside the image
                if not 0 <= r < h:
                    return np.zeros((8, 4, 8, 2), np.float32)
                cb = np.broadcast_to(c, (8, 4, 8))
                ok = (cb >= 0) & (cb < w)
                v = tile[r, _word_of(np.where(ok, cb, 0), q, t)]
                return np.where(ok[..., None], v, 0.0)

            for strip in plan["strip_rows"]:
                for cg in range(plan["col_groups"]):
                    col = cg * 8 + g
                    for i in range(STRIP_PAIRS):
                        for hh in range(2):
                            row = strip[2 * i + hh]
                            if mode == "pass":
                                terms = [ld(row, col)]
                            else:
                                terms = []
                                for pair in _tap_pairs(k):
                                    for tap in pair:
                                        ky, kx = divmod(tap, k)
                                        dy, dx = ((ky - p) * d, (kx - p) * d) if mode == "full" \
                                            else (0, 0)
                                        v = ld(row + dy, col + dx)
                                        prod = torch.from_numpy(v * wt[tap]).to(bf).float()
                                        terms.append(prod.numpy())
                            sums = np.sum(terms, axis=(0, 2, 3, 4), dtype=np.float64)  # per g
                            for gi in range(8):
                                if row < h and cg * 8 + gi < w:
                                    out[img, row, cg * 8 + gi] += sums[gi]
    return out[..., None] / e


@pytest.mark.parametrize("mode", ["pass", "arith", "full"])
def test_stencil_kernel_index_maps_emulated_match_plain(mode):
    """The kernel's tile swizzle, chain strips, windows and tap order,
    emulated at a ragged shape (20 rows in strips of 4, 40 columns in
    groups of 8, two channel slices), give the plain version's result to
    float32 summation order; each tap sits in exactly one MMA slot."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels.stencil_floor import (
        stencil_floor_plain,
    )

    for k, n_mma in ((5, 13), (3, 5)):
        pairs = _tap_pairs(k)
        assert len(pairs) == n_mma and sorted(sum(pairs, [])) == list(range(k * k))
    # 8 neighbouring columns of one chunk and pair fall in 8 distinct bank groups
    for col0 in range(0, 16, 8):
        banks = {_word_of(col0 + gi, 3, ti) % 32 for gi in range(8) for ti in range(4)}
        assert len(banks) == 32
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((1, 20, 40, 32)).astype(np.float32)).to(torch.bfloat16)
    w_exp = torch.from_numpy((rng.standard_normal((32, 128)) * 0.05).astype(np.float32))
    w_dw = torch.from_numpy((rng.standard_normal((25, 128)) * 0.05).astype(np.float32))
    got = _emulate_stencil_kernel(x, w_exp, w_dw, mode, 5, 2)
    want = stencil_floor_plain(x, w_exp, w_dw, mode, 5, 2).double().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
