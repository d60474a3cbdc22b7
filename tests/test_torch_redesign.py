"""The redesigned mask decode and block GEMM/depthwise kernels, checked on
the CPU where they can be: the decode's band factorisation emulated in numpy
(bit-equal to the plain version and to the JAX kernel in interpret mode),
the exactness of a bf16 x bf16 product in float32 that ``__hmul2`` relies
on, and the wrappers' pure-Python launch plans. The CUDA kernels themselves
are held against their plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.ops.pallas import fused_mask_decode as jax_decode
from mtg_card_image_segmentation_tpu.ops.pallas.fused_block import (
    fused_inverted_residual as jax_fir,
)

from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
from mtg_card_image_segmentation_tpu_torch.ops.kernels import fused_block as fb
from mtg_card_image_segmentation_tpu_torch.ops.kernels.decoder import (
    fused_mask_decode_plain,
    mask_decode_plan,
)
from mtg_card_image_segmentation_tpu_torch.ops.resize import _interp_taps

torch.set_num_threads(2)

SMS = 132  # an H100 SXM's multiprocessors: the plans' grids are sized by it


# --------------------------------------------------------------------------
# mask decode: the kernel's factorisation, emulated
# --------------------------------------------------------------------------


def _lerp2(w0, a, w1, b):
    """float32 ``w0*a + w1*b`` with each product and the sum rounded on its
    own (numpy does not contract into an FMA), as the kernel's lerp2."""
    return np.float32(w0) * a + np.float32(w1) * b


def _decode_by_bands(scores: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """What ``mask_decode_kernel`` computes, band by band as its plan cuts
    the rows: stage the band's source rows, row-lerp each source column once
    per output row, then the column lerp of 16-pixel groups from those rows
    (columns past the edge clamped, as the kernel's tap loads are)."""
    b, h, w = scores.shape
    plan = mask_decode_plan(b, h, w, out_h, out_w, SMS)
    lo_h, hi_h, w0_h, w1_h = _interp_taps(h, out_h)
    lo_w, hi_w, w0_w, w1_w = _interp_taps(w, out_w)
    out = np.zeros((b, out_h, out_w), np.uint8)
    band_rows = plan["band_rows"]
    for r0 in range(0, out_h, band_rows):
        rows = min(band_rows, out_h - r0)
        s0 = lo_h[r0]
        ns = hi_h[r0 + rows - 1] - s0 + 1
        assert ns <= plan["src_rows"]
        src = scores[:, s0:s0 + ns]
        r = np.arange(r0, r0 + rows)
        rl = _lerp2(w0_h[r][None, :, None], src[:, lo_h[r] - s0],
                    w1_h[r][None, :, None], src[:, hi_h[r] - s0])
        for g in range(plan["groups"]):
            j = np.minimum(np.arange(16 * g, 16 * g + 16), out_w - 1)
            v = _lerp2(w0_w[j], rl[:, :, lo_w[j]], w1_w[j], rl[:, :, hi_w[j]])
            keep = min(16, out_w - 16 * g)
            out[:, r0:r0 + rows, 16 * g:16 * g + keep] = (v[..., :keep] > 0)
    return out


@pytest.mark.parametrize(
    "b,h,w,out_h,out_w,seed",
    [(2, 40, 30, 320, 240, 3), (1, 40, 30, 320, 240, 8), (1, 13, 9, 100, 75, 4),
     (2, 8, 8, 64, 64, 5), (2, 64, 64, 512, 512, 9)],
)
def test_mask_decode_bands_bit_equal_plain_and_jax(b, h, w, out_h, out_w, seed):
    """Exact uint8 equality (tests/test_pallas.py:48-65's bar): a row-lerped
    value is the same float32 whether made once per source column or once
    per pixel, so the banded factorisation equals the plain version and the
    Pallas kernel (interpret) on every pixel, at integer and non-integer
    ratios."""
    scores = np.random.default_rng(seed).standard_normal((b, h, w)).astype(np.float32)
    ours = _decode_by_bands(scores, out_h, out_w)
    plain = fused_mask_decode_plain(torch.from_numpy(scores), out_h, out_w).numpy()
    theirs = np.asarray(jax_decode(jnp.asarray(scores), out_h, out_w, interpret=True))
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize(
    "b,h,w,out_h,out_w",
    [(128, 64, 64, 512, 512), (1, 40, 30, 320, 240), (128, 40, 30, 320, 240),
     (1, 13, 9, 100, 75)],
)
def test_mask_decode_plan(b, h, w, out_h, out_w):
    """Bands cover the rows, each band's source rows fit the staged count,
    shared memory stays under the 48 KB a launch gets without opting in, the
    grid has two CTAs per SM unless the bands are at their least, the block
    has at most 128 threads and its x threads cover the column groups (or
    loop over them)."""
    plan = mask_decode_plan(b, h, w, out_h, out_w, SMS)
    lo, hi, _, _ = _interp_taps(h, out_h)
    band = plan["band_rows"]
    assert band in (8, 16, 32, 64, 128)
    assert plan["n_bands"] * band >= out_h > (plan["n_bands"] - 1) * band
    for r0 in range(0, out_h, band):
        r1 = min(r0 + band, out_h) - 1
        assert hi[r1] - lo[r0] + 1 <= plan["src_rows"]
        assert np.all(np.diff(lo[r0:r1 + 1]) >= 0) and np.all(np.diff(hi[r0:r1 + 1]) >= 0)
    assert plan["smem_bytes"] == 16 * band + 4 * (plan["src_rows"] + band) * w <= 48 * 1024
    assert plan["groups"] == -(-out_w // 16)
    assert plan["gx"] == min(plan["groups"], 32) and plan["gx"] * plan["gy"] <= 128
    assert plan["n_bands"] * b >= 2 * SMS or band == 8
    if b == 128 and out_h == 512:
        assert band == 128


# --------------------------------------------------------------------------
# bf16 x bf16 products are exact in float32
# --------------------------------------------------------------------------


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns -> their exact values in float64."""
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _round_bf16_exact(p: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even of exact float64 values to bf16 (8 significant
    bits; subnormal spacing 2^-133; overflow to inf), done in float64 where
    every step is exact for a product of two bf16 (at most 16 significant
    bits)."""
    out = np.zeros_like(p)
    nz = p != 0
    e = np.floor(np.log2(np.abs(p[nz])))
    q = np.exp2(np.maximum(e, -126.0) - 7.0)
    out[nz] = np.rint(p[nz] / q) * q
    out[np.abs(out) > _bf16_values(np.array([0x7F7F]))[0]] = np.inf
    return np.copysign(out, p)


def _edge_pairs():
    tiny = [0x0001, 0x0003, 0x007F, 0x0080, 0x00FF]  # subnormals, the smallest normal
    big = [0x7F7F, 0x7F00, 0x7E80]                    # +max and near it
    one = [0x3F80, 0x3F81, 0x3FC0, 0x4000, 0x3F00]    # 1, 1+ulp, 1.5, 2, 0.5
    # ties: (1 + 2^-7 + 2^-7... ) pairs whose exact product sits halfway
    ties = [0x3F81, 0x3F83, 0x3FC1, 0x4041]
    a, b = [], []
    for x in tiny + big + one + ties:
        for y in one + ties + [0x3C00, 0x0002]:
            a.append(x)
            b.append(y)
    pairs = np.array([a, b], np.uint16)
    return np.concatenate([pairs, pairs ^ np.uint16(0x8000)], axis=1)


def test_bf16_products_exact_in_float32():
    """The ``__hmul2`` argument, on seeded pairs and edge pairs (subnormals,
    +-max, ties): wherever the exact product lies in float32's normal range
    or on its subnormal grid it is a float32 (so the fp32 multiply adds no
    rounding), and rounding that float32 to bf16 equals rounding the exact
    product to bf16 once, which is torch's bf16 multiply (the plain
    versions' ``y * w`` and ``y * gate``)."""
    rng = np.random.default_rng(11)
    seeded = rng.integers(0, 1 << 16, (2, 200_000), dtype=np.uint32).astype(np.uint16)
    bits = np.concatenate([seeded, _edge_pairs()], axis=1)
    finite = ((bits[0] & 0x7F80) != 0x7F80) & ((bits[1] & 0x7F80) != 0x7F80)
    bits = bits[:, finite]
    a, b = _bf16_values(bits[0]), _bf16_values(bits[1])
    exact = a * b  # float64: 16 significant bits, exponent in range
    with np.errstate(over="ignore"):  # +-max x 2 overflows in both
        f32 = (a.astype(np.float32) * b.astype(np.float32)).astype(np.float64)
    representable = (np.abs(exact) >= 2.0 ** -126) | (exact == 0) | \
        (np.mod(exact, 2.0 ** -149) == 0)
    in_range = representable & (np.abs(exact) <= np.finfo(np.float32).max)
    assert in_range.mean() > 0.45 and (~in_range).any()
    np.testing.assert_array_equal(f32[in_range], exact[in_range])
    ta = torch.from_numpy(bits[0].astype(np.int16)).view(torch.bfloat16)
    tb = torch.from_numpy(bits[1].astype(np.int16)).view(torch.bfloat16)
    torch_bf16 = (ta * tb).double().numpy()
    via_f32 = torch.from_numpy(f32.astype(np.float32)).to(torch.bfloat16).double().numpy()
    once = _round_bf16_exact(exact)
    np.testing.assert_array_equal(via_f32[in_range], once[in_range])
    np.testing.assert_array_equal(torch_bf16[in_range], once[in_range])


# --------------------------------------------------------------------------
# GEMM launch plans and the plain GEMM
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [300, 600, 131072])
@pytest.mark.parametrize("n", [112, 160, 472, 672, 960])
def test_gemm_plan(m, n):
    """For every K of the serving widths: tiles of 80, 160 or 240 columns
    that cover N with no empty tile, 128-row tiles, the K tail zero-filled
    up to wgmma's depth of 16 inside 64-deep k tiles, the shared memory of
    the ring under 227 KB (at least 3 streaming or 4 resident stages), a
    persistent grid of at most one CTA per SM, a multiple of the n tiles
    when B is resident, and B resident only without a gate."""
    for k in (112, 160, 472, 672, 960):
        for gated in (False, True):
            p = fb.gemm_plan(m, n, k, gated, SMS)
            assert p["bn"] in fb.GEMM_BN and p["bn"] % 80 == 0
            assert p["n_tiles"] * p["bn"] >= n > (p["n_tiles"] - 1) * p["bn"]
            assert p["n_tiles"] == -(-n // 240)
            assert p["m_tiles"] * 128 >= m > (p["m_tiles"] - 1) * 128
            assert p["k_pad16"] % 16 == 0 and k <= p["k_pad16"] < k + 16
            assert p["k_loaded"] == 64 * p["k_tiles"] >= p["k_pad16"]
            assert p["smem_bytes"] <= fb.SMEM_LIMIT
            assert p["smem_bytes"] == fb.gemm_smem(p["bn"], p["stages"], p["resident"],
                                                   p["k_tiles"])
            assert p["stages"] >= (4 if p["resident"] else 3)
            assert 1 <= p["grid"] <= min(SMS, p["n_tiles"] * p["m_tiles"])
            if p["resident"]:
                assert not gated and p["grid"] % p["n_tiles"] == 0
    assert fb.gemm_plan(m, 960, 160, False, SMS)["bn"] == 240
    assert fb.gemm_plan(m, 672, 112, False, SMS)["bn"] == 240
    assert fb.gemm_plan(m, 160, 960, True, SMS)["n_tiles"] == 1  # A read once
    assert fb.gemm_plan(m, 472, 112, False, SMS)["n_tiles"] == 2


def test_pw_gemm_plain_gate_spans_two_images():
    """The plain GEMM (the kernels' K4 on the CPU): a gate per image of 300
    rows, so 128-row tiles straddle images; each A value is multiplied by
    its own image's gate with a bf16 rounding, then the fp32 product, bias
    and residual. Against a numpy evaluation of the same roundings (float64
    sums of exact bf16 x bf16 products, so 1e-5 covers fp32 sum order)."""
    rng = np.random.default_rng(12)
    m, k, n, rpi = 600, 472, 160, 300
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((n, k)) / 20).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    gate = torch.from_numpy(rng.uniform(0, 1, (2, k)).astype(np.float32)).to(torch.bfloat16)
    res = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    _build.reset_launches()
    got = fb.pw_gemm(a, w, bias, gate, rpi, res, None, torch.float32)
    assert _build.LAUNCHES == {}
    gated = np.concatenate([(a[:rpi] * gate[0]).float().numpy(),
                            (a[rpi:] * gate[1]).float().numpy()])
    want = gated.astype(np.float64) @ w.float().numpy().T.astype(np.float64)
    want = want + bias.numpy() + res.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the two images' rows differ in their gates: the same A row under the
    # other image's gate gives another result
    swapped = fb.pw_gemm_plain(a, w, bias, gate.flip(0), rpi, res, None, torch.float32)
    assert not torch.equal(swapped, got)


def test_kernel_block_needs_bf16_rounding_of_a_float32_input():
    """K1 reads bf16 only: the chain hands a float32 value between blocks
    together with its bf16 rounding (the previous K4's copy); a float32
    input without it, or with a copy of another shape, is refused before
    any launch rather than converted behind the caller's back."""
    rng = np.random.default_rng(13)
    p = {"expand": {"conv": {"kernel": rng.standard_normal((1, 1, 16, 32)).astype(np.float32),
                             "bias": np.zeros(32, np.float32)}},
         "depthwise": {"conv": {"kernel": rng.standard_normal((3, 3, 1, 32)).astype(np.float32),
                                "bias": np.zeros(32, np.float32)}},
         "project": {"conv": {"kernel": rng.standard_normal((1, 1, 32, 16)).astype(np.float32),
                              "bias": np.zeros(16, np.float32)}}}
    bw = fb.BlockWeights.from_flax(p, 3)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 16)).astype(np.float32))
    _build.reset_launches()
    with pytest.raises(ValueError):
        fb.inverted_residual_kernels(x, bw, 1, "relu", True, 1, torch.float32)
    with pytest.raises(ValueError):
        fb.inverted_residual_kernels(x, bw, 1, "relu", True, 1, torch.float32,
                                     x_bf16=x[:, :2].to(torch.bfloat16))
    assert _build.LAUNCHES == {}


# --------------------------------------------------------------------------
# depthwise kernel sizes other than the model's 3 and 5
# --------------------------------------------------------------------------


def _block_tree(cin, exp, cout, k, seed):
    rng = np.random.default_rng(seed)

    def conv(kh, ci, co, fan_in):
        return {"kernel": (rng.standard_normal((kh, kh, ci, co)) / np.sqrt(fan_in))
                .astype(np.float32),
                "bias": (0.1 * rng.standard_normal(co)).astype(np.float32)}

    p = {"expand": {"conv": conv(1, cin, exp, cin)},
         "depthwise": {"conv": conv(k, 1, exp, k * k)},
         "se": {"fc1": conv(1, exp, 16, exp), "fc2": conv(1, 16, exp, 16)},
         "project": {"conv": conv(1, exp, cout, exp)}}
    x = rng.standard_normal((2, 16, 16, cin)).astype(np.float32)
    return x, p


@pytest.mark.parametrize("k,stride,dilation", [(7, 1, 1), (7, 2, 1), (1, 1, 1), (7, 1, 2)])
def test_block_at_other_odd_kernel_sizes_matches_jax_kernel(k, stride, dilation):
    """The JAX block takes any kernel size, and so does the port: its plain
    version (the kernels' reference; the depthwise kernel has a run-time-k
    instance beside the unrolled 3 and 5) against the Pallas kernel
    (interpret) at k = 7 and k = 1, tolerance 0.05 as for the model's
    blocks (tests/test_pallas_fused_block.py:58)."""
    x, folded = _block_tree(24, 64, 24, k, seed=20 + k)
    theirs = np.asarray(jax_fir(jnp.asarray(x), folded, kernel_size=k, stride=stride,
                                act="hardswish", residual=stride == 1, dilation=dilation,
                                interpret=True))
    ours = fb.fused_inverted_residual(torch.from_numpy(x), folded, kernel_size=k, stride=stride,
                                   act="hardswish", residual=stride == 1, dilation=dilation)
    assert tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("k", [2, 4, 0])
def test_depthwise_kernel_refuses_an_even_kernel_size(k):
    """An even (or no) kernel size has no centred window: the depthwise
    step says so before any build or launch, rather than failing with a
    bare CUDA error."""
    bw = fb.BlockWeights(kernel_size=k, dw_w=torch.zeros(max(k * k, 1), 16, dtype=torch.bfloat16),
                         dw_b=torch.zeros(16), proj_w=torch.zeros(16, 16, dtype=torch.bfloat16),
                         proj_b=torch.zeros(16))
    y = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    _build.reset_launches()
    with pytest.raises(ValueError, match="odd kernel size"):
        fb._depthwise(y, bw, 1, "relu", 1)
    assert _build.LAUNCHES == {}
