"""The redesigned stem and head-decode kernels, checked on the CPU where they
can be: the head decode's tree-order channel sum against a numpy emulation
of the kernel's lane butterfly, its band plan, and the whole kernel emulated
band by band (bit-equal to the plain version); the stem's implicit GEMM
emulated from the kernel's own window layout and K pairs, against the plain
version's sums, and its load-width plan. The CUDA kernels themselves are
held against their plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from mtg_card_image_segmentation_tpu_torch.ops.kernels import decoder as dec
from mtg_card_image_segmentation_tpu_torch.ops.kernels import stem as stem_k
from mtg_card_image_segmentation_tpu_torch.ops.resize import _interp_taps

torch.set_num_threads(2)

SMS = 132  # an H100 SXM's multiprocessors: the plans' grids are sized by it


# --------------------------------------------------------------------------
# head decode: the channel sums' tree order
# --------------------------------------------------------------------------


def _chunk_sums(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """float32 chunk sums as a lane makes them: chunks of 8 channels (the
    last zero-padded), each summed product by product in channel order,
    every product and sum rounded to float32."""
    c = x.shape[-1]
    pad = -c % 8
    x = np.concatenate([x, np.zeros((*x.shape[:-1], pad), np.float32)], -1)
    w = np.concatenate([np.broadcast_to(w, (*x.shape[:-1], c)),
                        np.zeros((*x.shape[:-1], pad), np.float32)], -1)
    xs = x.reshape(*x.shape[:-1], -1, 8)
    ws = w.reshape(*w.shape[:-1], -1, 8)
    acc = np.zeros(xs.shape[:-1], np.float32)
    for j in range(8):
        acc = acc + xs[..., j] * ws[..., j]
    return acc


def _butterfly(partials: np.ndarray) -> np.ndarray:
    """The kernel's lane butterfly: P lanes (partials zero-padded to a power
    of two), each adding the value __shfl_xor_sync brings from lane k ^ o,
    o = 1, 2, 4, ...; every lane ends with the sum, lane 0's is taken."""
    n = partials.shape[-1]
    p = 1
    while p < n:
        p *= 2
    lanes = np.concatenate([partials, np.zeros((*partials.shape[:-1], p - n), np.float32)], -1)
    k = np.arange(p)
    o = 1
    while o < p:
        lanes = lanes + lanes[..., k ^ o]
        o *= 2
    return lanes[..., 0]


def _in_register_tree(partials: np.ndarray) -> np.ndarray:
    """The one-lane form (``channel_sums_per_lane``): p[j] += p[j + s] for
    s = 1, 2, 4 over the partials zero-padded to a power of two."""
    n = partials.shape[-1]
    p = 1
    while p < n:
        p *= 2
    v = [partials[..., i] if i < n else np.zeros(partials.shape[:-1], np.float32)
         for i in range(p)]
    s = 1
    while s < p:
        for j in range(0, p, 2 * s):
            v[j] = v[j] + v[j + s]
        s *= 2
    return v[0]


@pytest.mark.parametrize("c", [128, 40, 24, 72, 12])
@pytest.mark.parametrize("per_image", [True, False])
def test_tree_channel_sum_is_the_lane_butterfly(c, per_image):
    """Bit for bit: the plain version's tree order is the butterfly of the
    kernel's stage 1 and the in-register tree of its stage 2, at the head's
    widths (C = 128, Cl = 40), the ragged case's 24, 9 chunks (not a power of
    two) and a channel count that is no multiple of 8."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((3, 5, 7, c)).astype(np.float32)
    w = rng.standard_normal((3, c) if per_image else (c,)).astype(np.float32)
    wb = w[:, None, None, :] if per_image else w
    ours = dec._tree_channel_sum(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    partials = _chunk_sums(x, wb)
    np.testing.assert_array_equal(ours, _butterfly(partials))
    np.testing.assert_array_equal(ours, _in_register_tree(partials))


@pytest.mark.parametrize("c", [128, 40, 24])
def test_tree_channel_sum_within_float32_rounding_of_sequential(c):
    """The tree order and the old sequential order differ only by float32
    rounding: each within C ulps of the exact sum's terms."""
    rng = np.random.default_rng(100 + c)
    x = rng.standard_normal((4, 6, 6, c)).astype(np.float32)
    w = rng.standard_normal((c,)).astype(np.float32)
    tree = dec._tree_channel_sum(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    seq = np.zeros(x.shape[:-1], np.float32)
    for i in range(c):
        seq = seq + x[..., i] * w[i]
    exact = (x.astype(np.float64) * w).sum(-1)
    scale = np.abs(x.astype(np.float64) * w).sum(-1)
    bound = c * 2.0 ** -24 * scale
    assert np.all(np.abs(tree - exact) <= bound)
    assert np.all(np.abs(seq - exact) <= bound)
    assert np.all(np.abs(tree.astype(np.float64) - seq) <= 2 * bound)


def test_tree_order_case_tells_summation_orders_apart():
    """The case chip_smoke.py holds the kernel to: in the tree order (the
    plain version's, the butterfly's, the in-register tree's) every score
    is 0 and the mask is empty; with the butterfly's offsets reversed, or
    the in-register tree's levels swapped, the 2^-24 survives and every
    pixel of that image is set, so a kernel summing in another order fails
    the exact gate."""
    x, gw, low, w_lo, bias, out_h, out_w = dec.tree_order_case()
    plain = dec.fused_head_decode_plain(x, gw, low, w_lo, bias, out_h, out_w)
    assert int(plain.sum()) == 0
    px = _chunk_sums(x.float().numpy(), gw.numpy()[:, None, None, :])
    pl = _chunk_sums(low.float().numpy(), w_lo.numpy())
    assert np.all(_butterfly(px) == 0) and np.all(_in_register_tree(pl) == 0)
    lanes = np.concatenate([px, np.zeros((*px.shape[:-1], 1), np.float32)], -1)
    k = np.arange(4)
    for o in (2, 1):  # the butterfly's offsets in reverse
        lanes = lanes + lanes[..., k ^ o]
    assert np.all(lanes[0, ..., 0] == np.float32(2.0 ** -24))
    swapped = (pl[..., 0] + pl[..., 2]) + (pl[..., 1] + 0)  # levels s = 2, then 1
    assert np.all(swapped[1] == np.float32(2.0 ** -24))


# --------------------------------------------------------------------------
# head decode: the band plan and the kernel emulated band by band
# --------------------------------------------------------------------------

HEAD_SHAPES = [  # (h16, w16, C, h8, w8, Cl, out_h, out_w)
    (32, 32, 128, 64, 64, 40, 512, 512),
    (20, 15, 128, 40, 30, 40, 320, 240),
    (10, 8, 24, 20, 16, 16, 160, 128),
]


@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_decode_plan(b, shape, capsys):
    """Every output row in exactly one band; each band's stride-8 rows hold
    every tap its rows read and its stride-16 rows every tap of those; the
    shared bytes within a CTA's 227 KB; two CTAs per SM unless the bands are
    at their least; the halo re-read at most 1.25x at b128 for the serving
    shapes (the ratio is printed for every case)."""
    h16, w16, c, h8, w8, cl, out_h, out_w = shape
    plan = dec.head_decode_plan(b, h16, w16, c, h8, w8, cl, out_h, out_w, SMS)
    lo_v, hi_v, _, _ = _interp_taps(h8, out_h)
    lo_u, hi_u, _, _ = _interp_taps(h16, h8)
    band = plan["band_rows"]
    covered = np.zeros(out_h, np.int64)
    for k, (s0, ns, t0, nt) in enumerate(plan["bands"]):
        rows = np.arange(k * band, min((k + 1) * band, out_h))
        covered[rows] += 1
        assert s0 <= lo_v[rows].min() and hi_v[rows].max() < s0 + ns <= h8
        s8 = np.arange(s0, s0 + ns)
        assert t0 <= lo_u[s8].min() and hi_u[s8].max() < t0 + nt <= h16
        assert ns <= plan["max_s8_rows"] and nt <= plan["max_hs_rows"]
    assert np.all(covered == 1) and plan["n_bands"] == len(plan["bands"])
    assert plan["smem_bytes"] == 16 * (band + plan["max_s8_rows"] + w8) + 4 * (
        64 + plan["max_hs_rows"] * w16 + plan["max_s8_rows"] * w8 + band * w8)
    assert plan["smem_bytes"] <= 227 * 1024
    assert b * plan["n_bands"] >= 2 * SMS or band == 8
    assert plan["gx"] * plan["gy"] <= dec.HEAD_THREADS and plan["gx"] == min(-(-out_w // 16), 32)
    with capsys.disabled():
        print(f"\nhead_decode_plan b{b} {out_h}x{out_w}: {band} rows per band, "
              f"re-read {plan['reread']:.3f}x")
    if b == 128 and out_h in (512, 320):
        assert plan["reread"] <= 1.25


def _lerp2(w0, a, w1, b):
    return np.float32(w0) * a + np.float32(w1) * b


def _head_by_bands(x, gw, low, w_lo, bias, out_h, out_w):
    """What ``head_decode_kernel`` computes, band by band as its plan cuts
    the rows: the band's hs rows (tree-order sums), its s rows (the 2x lerp
    of hs from the staged row and column taps, + the low sums, + bias), then
    the band's row lerp and the column lerp of 16-pixel groups."""
    b, h16, w16, c = x.shape
    _, h8, w8, cl = low.shape
    plan = dec.head_decode_plan(b, h16, w16, c, h8, w8, cl, out_h, out_w, SMS)
    lo_u, hi_u, w0_u, w1_u = _interp_taps(h16, h8)
    lo_c, hi_c, w0_c, w1_c = _interp_taps(w16, w8)
    lo_v, hi_v, w0_v, w1_v = _interp_taps(h8, out_h)
    lo_w, hi_w, w0_w, w1_w = _interp_taps(w8, out_w)
    part_x = _chunk_sums(x, gw[:, None, None, :])
    part_l = _chunk_sums(low, w_lo)
    out = np.zeros((b, out_h, out_w), np.uint8)
    band = plan["band_rows"]
    for k, (s0, ns, t0, nt) in enumerate(plan["bands"]):
        hs = _butterfly(part_x[:, t0:t0 + nt])                     # (b, nt, w16)
        ls = _in_register_tree(part_l[:, s0:s0 + ns])              # (b, ns, w8)
        y = np.arange(s0, s0 + ns)
        top, bot = hs[:, lo_u[y] - t0], hs[:, hi_u[y] - t0]        # (b, ns, w16)
        a0, a1 = w0_u[y][None, :, None], w1_u[y][None, :, None]
        up = _lerp2(w0_c, _lerp2(a0, top[..., lo_c], a1, bot[..., lo_c]),
                    w1_c, _lerp2(a0, top[..., hi_c], a1, bot[..., hi_c]))
        s = (up + ls) + np.float32(bias)
        rows = np.arange(k * band, min((k + 1) * band, out_h))
        rl = _lerp2(w0_v[rows][None, :, None], s[:, lo_v[rows] - s0],
                    w1_v[rows][None, :, None], s[:, hi_v[rows] - s0])
        for g in range(-(-out_w // 16)):
            j = np.minimum(np.arange(16 * g, 16 * g + 16), out_w - 1)
            v = _lerp2(w0_w[j], rl[..., lo_w[j]], w1_w[j], rl[..., hi_w[j]])
            keep = min(16, out_w - 16 * g)
            out[:, rows, 16 * g:16 * g + keep] = v[..., :keep] > 0
    return out


@pytest.mark.parametrize("b,shape,seed", [(2, HEAD_SHAPES[2], 5), (2, HEAD_SHAPES[1], 6),
                                          (1, HEAD_SHAPES[0], 7)])
def test_head_decode_bands_bit_equal_plain(b, shape, seed):
    """The kernel's factorisation (bands with halo rows, tree sums, staged
    taps, row lerp once per stride-8 column) gives the plain version's mask
    exactly, at the ragged case, the server's size and 512x512."""
    h16, w16, c, h8, w8, cl, out_h, out_w = shape
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    x = bf(rng.standard_normal((b, h16, w16, c)).astype(np.float32))
    low = bf(rng.standard_normal((b, h8, w8, cl)).astype(np.float32))
    gw = (rng.standard_normal((b, c)) * 0.2).astype(np.float32)
    w_lo = (rng.standard_normal(cl) * 0.2).astype(np.float32)
    ours = _head_by_bands(x, gw, low, w_lo, 0.05, out_h, out_w)
    plain = dec.fused_head_decode_plain(*(torch.from_numpy(a) for a in (x, gw, low, w_lo)),
                                        0.05, out_h, out_w).numpy()
    assert 0.2 < plain.mean() < 0.8
    np.testing.assert_array_equal(ours, plain)


# --------------------------------------------------------------------------
# stem: the implicit GEMM from the kernel's window and K pairs
# --------------------------------------------------------------------------


def _stem_operands(seed):
    rng = np.random.default_rng(seed)
    kernel = torch.from_numpy((rng.standard_normal((3, 3, 3, 16)) * 0.1).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(16) * 0.1).astype(np.float32))
    center = torch.tensor([123.675, 116.28, 103.53])
    return stem_k.prepare_stem(kernel, bias, center)


def test_stem_b_operand_layout():
    """B's 32 K rows hold the bf16 weights of the taps ``k_taps`` names and
    zeros elsewhere (K = 0, 10, 20, 30, 31); the (16, 16) int32 pairs hold
    K rows 2q (low half) and 2q + 1 (high half) of channel n at [q, n]."""
    ops = _stem_operands(1)
    taps = stem_k.k_taps()
    assert sorted(taps[taps >= 0].tolist()) == list(range(27))
    assert np.flatnonzero(taps < 0).tolist() == [0, 10, 20, 30, 31]
    bits = ops.pairs.numpy().view(np.uint32)
    for q in range(16):
        for half, kk in ((bits[q] & 0xFFFF, 2 * q), (bits[q] >> 16, 2 * q + 1)):
            vals = torch.from_numpy((half.astype(np.uint32) << 16).view(np.float32))
            want = ops.w27[taps[kk]] if taps[kk] >= 0 else torch.zeros(16)
            assert torch.equal(vals, want)


def _kernel_window(img_u8, center_bf, tile_oy0, tile_ox0, vec):
    """The centered bf16 window of one tile as ``stem_kernel`` builds it:
    33 rows of ``row_elems`` values, element e = column * 3 + channel at
    index e + pre, copied in ``vec``-byte words that lie wholly inside an
    image row or are zero."""
    h, w, _ = img_u8.shape
    plan = stem_k.stem_plan(1, h, w, SMS, aligned16=vec == 16)
    assert plan["vec_bytes"] == vec
    pre, row = plan["pre"], plan["row_elems"]
    flat = img_u8.reshape(h, w * 3)
    win = np.zeros((2 * stem_k.TILE_H + 1, row), np.float32)
    for r in range(win.shape[0]):
        y = 2 * tile_oy0 - 1 + r
        for k in range(row // vec):
            gb = 6 * tile_ox0 - 3 - pre + k * vec
            if not (0 <= y < h and gb >= 0 and gb + vec <= 3 * w):
                continue
            for j in range(vec):
                e = k * vec + j - pre
                win[r, k * vec + j] = np.float32(flat[y, gb + j]) - center_bf[e % 3]
    return torch.from_numpy(win).bfloat16().float().numpy(), pre


@pytest.mark.parametrize("h,w,vec", [(40, 24, 4), (48, 160, 16), (40, 144, 4)])
def test_stem_implicit_gemm_from_kernel_window(h, w, vec):
    """A, gathered from the kernel's window by its pair offsets (the value
    pair at positions 2j - 1, 2j of tap row ky, 4-byte aligned), times the
    padded B equals the plain version's sums within float32 rounding, for
    every output pixel of every tile (the ragged last tile included), on the
    16-byte and the 4-byte load paths. The zero rows of B meet real values:
    dropping their zeros would change the result."""
    rng = np.random.default_rng(h + w)
    ops = _stem_operands(2)
    img = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    want = stem_k.stem_preact_plain(torch.from_numpy(img), ops)[0].numpy().astype(np.float64)
    taps = stem_k.k_taps()
    b_mat = np.stack([ops.w27[t].numpy() if t >= 0 else np.zeros(16, np.float32) for t in taps])
    center = ops.center.numpy()
    ho, wo = h // 2, w // 2
    got = np.zeros((ho, wo, 16))
    absum = np.zeros((ho, wo, 16))
    padded_terms = 0.0
    for oy0 in range(0, ho, stem_k.TILE_H):
        for ox0 in range(0, wo, stem_k.TILE_W):
            win, pre = _kernel_window(img[0], center, oy0, ox0, vec)
            row = win.shape[1]
            for ly in range(min(stem_k.TILE_H, ho - oy0)):
                for lx in range(min(stem_k.TILE_W, wo - ox0)):
                    base = 2 * ly * row + pre + 6 * lx
                    a = np.zeros(32)
                    for q in range(16):
                        off = (q // 5) * row + 2 * (q % 5) - 1 if q < 15 else -1
                        assert (base + off) % 2 == 0  # one 32-bit shared load
                        a[2 * q:2 * q + 2] = win.reshape(-1)[base + off:base + off + 2]
                    got[oy0 + ly, ox0 + lx] = a @ b_mat
                    absum[oy0 + ly, ox0 + lx] = np.abs(a) @ np.abs(b_mat)
                    padded_terms += np.abs(a[taps < 0]).sum()
    # the plain version's 27 float32 roundings, each at most half an ulp of
    # a partial sum no larger than the sum of the terms' magnitudes
    assert np.all(np.abs(got - want) <= 27 * 2.0 ** -24 * absum)
    assert padded_terms > 0


@pytest.mark.parametrize("w,vec", [(24, 4), (512, 16), (320, 16), (240, 16), (40, 4)])
def test_stem_plan_load_width(w, vec):
    """16-byte window words when an image row (3 W bytes) is a multiple of
    16 bytes, else 4-byte words; 4-byte words also for images that are not
    16-byte aligned; shared bytes within a CTA's share of the SM for three
    CTAs; the persistent grid at most three CTAs per SM and one per tile."""
    plan = stem_k.stem_plan(128, 320, w, SMS)
    assert plan["vec_bytes"] == vec
    assert stem_k.stem_plan(128, 320, w, SMS, aligned16=False)["vec_bytes"] == 4
    for out_bytes in (2, 4):
        p = stem_k.stem_plan(128, 320, w, SMS, out_bytes)
        assert 3 * (p["smem_bytes"] + 1024) <= 228 * 1024
    assert plan["grid"] == min(plan["n_tiles"], 3 * SMS)
    assert plan["n_tiles"] == 128 * -(-160 // stem_k.TILE_H) * -(-(w // 2) // stem_k.TILE_W)
