"""Decoder kernels of the LR-ASPP head (counterpart of the JAX package's
``ops/pallas/decoder.py``). The CUDA kernels are in ``csrc/decoder.cu``;
beside each wrapper stands its plain PyTorch version (``*_plain``), bit-equal
to the kernel, which the wrapper takes only for CPU tensors.

- ``fused_mask_decode``: (B, h, w) float32 card-minus-background score ->
  (B, H, W) uint8 mask, ``bilinear_resize(score) > 0``, which equals
  ``argmax`` of the resized two-class logits because the resize is linear.
- ``fused_head_decode``: the head's tail and the mask decode in one launch:
  ``score_s8 = up2x(sum_c x*gw) + sum_c low*w_lo + bias``, then the mask
  decode of ``score_s8``.
- ``upsample2x_add``: exact 2x half-pixel bilinear upsample + add, the
  head's feature merge.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
from mtg_card_image_segmentation_tpu_torch.ops.resize import _interp_taps
from mtg_card_image_segmentation_tpu_torch.utils.profiling import Span

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 10 + [_I] * 9 + [_P]
_HEAD_ARGS = [_P] * 8 + [_I] * 16 + [_P]
_UP_ARGS = [_P] * 3 + [_I] * 5 + [_P]
HEAD_THREADS = 128  # threads of a head-decode CTA (csrc/decoder.cu)

_TAPS: Dict[Tuple[int, int, str], Tuple[torch.Tensor, ...]] = {}
_CACHE_LOCK = threading.Lock()  # the per-shape tables fill once, from any thread
_MASK_DECODE = Span("kernel.fused_mask_decode", "kernels")
_HEAD_DECODE = Span("kernel.fused_head_decode", "kernels")


def interp_taps(in_size: int, out_size: int, device: torch.device):
    """(lo, hi, w0, w1) tensors on ``device``, cached per shape."""
    key = (in_size, out_size, str(device))
    with _CACHE_LOCK:
        if key not in _TAPS:
            _TAPS[key] = tuple(torch.from_numpy(a).to(device)
                               for a in _interp_taps(in_size, out_size))
        return _TAPS[key]


def _lerp_taps(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, h, w) float32 -> (B, out_h, out_w): row lerp, then column lerp,
    ``w0*a + w1*b`` each."""
    _, h, w = x.shape
    lo_h, hi_h, w0_h, w1_h = interp_taps(h, out_h, x.device)
    lo_w, hi_w, w0_w, w1_w = interp_taps(w, out_w, x.device)
    up = w0_h[:, None] * x[:, lo_h.long(), :] + w1_h[:, None] * x[:, hi_h.long(), :]
    return w0_w * up[:, :, lo_w.long()] + w1_w * up[:, :, hi_w.long()]


def fused_mask_decode_plain(scores: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Row lerp, then column lerp, ``w0*a + w1*b`` each, then ``> 0``."""
    return (_lerp_taps(scores.float(), out_h, out_w) > 0.0).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def mask_decode_plan(b: int, h: int, w: int, out_h: int, out_w: int,
                     sm_count: int) -> Dict[str, int]:
    """The mask decode's launch plan: output rows per CTA (128, halved down
    to 8 while the grid has fewer than two CTAs per SM), the band count, the
    most source rows one band reads (the half-pixel taps are nondecreasing,
    so a band reads rows lo[first] .. hi[last]), the shared-memory bytes
    (the band's row taps, 16 bytes each; those rows and the band's
    row-lerped rows, float32) and the block
    shape: ``gx`` threads across the 16-pixel column groups, ``gy`` across
    rows, 128 threads (more CTAs per SM). ``sm_count`` is the card's
    multiprocessor count."""
    lo, hi, _, _ = _interp_taps(h, out_h)
    band_rows = 128
    while band_rows > 8 and b * -(-out_h // band_rows) < 2 * sm_count:
        band_rows //= 2
    starts = np.arange(0, out_h, band_rows)
    ends = np.minimum(starts + band_rows, out_h) - 1
    src_rows = int((hi[ends] - lo[starts]).max()) + 1
    groups = -(-out_w // 16)
    gx = min(groups, 32)
    return {"band_rows": band_rows, "n_bands": len(starts), "src_rows": src_rows,
            "smem_bytes": 16 * band_rows + 4 * (src_rows + band_rows) * w, "gx": gx,
            "gy": max(1, 128 // gx),
            "groups": groups}


def fused_mask_decode(scores: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, h, w) float32 -> (B, out_h, out_w) uint8 {0,1}. Launches the
    CUDA kernel for a CUDA tensor; a CPU tensor takes the plain version."""
    if scores.device.type == "cpu":
        return fused_mask_decode_plain(scores, out_h, out_w)
    with _MASK_DECODE:
        if scores.device.type != "cuda":
            raise ValueError(f"unsupported device {scores.device}")
        if scores.dim() != 3 or scores.dtype != torch.float32:
            raise ValueError(f"want (B, h, w) float32, got {tuple(scores.shape)} {scores.dtype}")
        scores = scores.contiguous()
        b, h, w = scores.shape
        plan = mask_decode_plan(b, h, w, out_h, out_w, _build.sm_count(scores.device))
        taps_h = interp_taps(h, out_h, scores.device)
        taps_w = interp_taps(w, out_w, scores.device)
        out = torch.empty((b, out_h, out_w), dtype=torch.uint8, device=scores.device)
        fn = _build.bind("decoder", "mtg_fused_mask_decode", _ARGS)
        err = fn(scores.data_ptr(), *(t.data_ptr() for t in taps_h),
                 *(t.data_ptr() for t in taps_w), out.data_ptr(),
                 b, h, w, out_h, out_w, plan["band_rows"], plan["src_rows"], plan["gx"],
                 plan["gy"], _build.stream_ptr(scores))
        _build.check(err, "fused_mask_decode")
        _build.count("fused_mask_decode")
        return out


# --------------------------------------------------------------------------
# fused_head_decode
# --------------------------------------------------------------------------

_HEAD_LAUNCH: Dict[Tuple, Tuple] = {}


@functools.lru_cache(maxsize=64)
def head_decode_plan(b: int, h16: int, w16: int, c: int, h8: int, w8: int, cl: int,
                     out_h: int, out_w: int, sm_count: int) -> Dict[str, object]:
    """The head decode's launch plan. Output rows per band (one CTA each):
    128, halved down to 8 while the grid has fewer than two CTAs per SM.
    ``bands``: per band (s8_row0, s8_rows, hs_row0, hs_rows), the stride-8
    and stride-16 rows its lerps read (the half-pixel taps are
    nondecreasing, so a band reads lo[first] .. hi[last]); the largest of
    each; the shared bytes (the taps of the band's output rows, stride-8
    rows and columns, 16 bytes each; w_lo, hs rows, s rows and the
    row-lerped rows, float32); the decode stage's grid of ``HEAD_THREADS``
    threads, ``gx`` across column groups of 16 by ``gy``; and ``reread``,
    the bytes of x and low the bands read over the bytes of one read (the
    halo rows neighbouring bands both read)."""
    lo_v, hi_v, _, _ = _interp_taps(h8, out_h)
    lo_u, hi_u, _, _ = _interp_taps(h16, h8)
    band_rows = 128
    while band_rows > 8 and b * -(-out_h // band_rows) < 2 * sm_count:
        band_rows //= 2
    rows = []
    for r0 in range(0, out_h, band_rows):
        r1 = min(r0 + band_rows, out_h) - 1
        s0, s1 = int(lo_v[r0]), int(hi_v[r1])
        t0, t1 = int(lo_u[s0]), int(hi_u[s1])
        rows.append((s0, s1 - s0 + 1, t0, t1 - t0 + 1))
    table = np.asarray(rows, np.int32)
    table.flags.writeable = False
    max_hs, max_s8 = int(table[:, 3].max()), int(table[:, 1].max())
    read = int(table[:, 3].sum()) * w16 * c + int(table[:, 1].sum()) * w8 * cl
    gx = min(-(-out_w // 16), 32)
    return {"band_rows": band_rows, "n_bands": len(rows), "bands": table,
            "max_hs_rows": max_hs, "max_s8_rows": max_s8,
            "smem_bytes": 16 * (band_rows + max_s8 + w8)
            + 4 * (64 + max_hs * w16 + max_s8 * w8 + band_rows * w8),
            "gx": gx, "gy": HEAD_THREADS // gx,
            "reread": read / (h16 * w16 * c + h8 * w8 * cl)}


def _head_launch(key: Tuple, device: torch.device):
    """(plan, band table on ``device``, the 16 tap tables and a ctypes array
    of their pointers) for one shape, cached: the per-call host work of the
    wrapper is one lookup."""
    dkey = key + (str(device),)
    with _CACHE_LOCK:
        hit = _HEAD_LAUNCH.get(dkey)
    if hit is None:
        _, h16, w16, _, h8, w8, _, out_h, out_w, _ = key
        plan = head_decode_plan(*key)
        taps = (interp_taps(h16, h8, device) + interp_taps(w16, w8, device)
                + interp_taps(h8, out_h, device) + interp_taps(w8, out_w, device))
        ptrs = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in taps))
        bands = torch.from_numpy(np.array(plan["bands"])).to(device)
        hit = (plan, bands, taps, ptrs)
        with _CACHE_LOCK:
            hit = _HEAD_LAUNCH.setdefault(dkey, hit)
    return hit


def _check_head(x, gw, low, w_lo) -> None:
    if x.dim() != 4 or low.dim() != 4 or x.shape[0] != low.shape[0]:
        raise ValueError(f"want (B, h16, w16, C) and (B, h8, w8, Cl), got "
                         f"{tuple(x.shape)} and {tuple(low.shape)}")
    if tuple(gw.shape) != (x.shape[0], x.shape[3]) or tuple(w_lo.shape) != (low.shape[3],):
        raise ValueError(f"want gw (B, C) and w_lo (Cl,), got {tuple(gw.shape)} and "
                         f"{tuple(w_lo.shape)}")


def _tree_channel_sum(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """sum_c x[..., c] * weight[..., c] in float32 in the kernel's order:
    chunks of 8 channels (the last zero-padded), each summed in channel
    order, product then sum, each rounded on its own; then the chunk sums,
    zero-padded to a power of two, combined pairwise, ``p[..., 0::2] +
    p[..., 1::2]``, until one is left. ``weight`` is (C,) or (B, C)."""
    xf = x.float()
    wf = weight.float()
    if wf.dim() == 2:
        wf = wf[:, None, None, :]
    c = xf.shape[-1]
    pad = -c % 8
    prod_shape = torch.broadcast_shapes(xf.shape, wf.shape)
    xf = torch.nn.functional.pad(xf, (0, pad))
    wf = torch.nn.functional.pad(wf, (0, pad))
    chunks = (c + pad) // 8
    xs = xf.reshape(*xf.shape[:-1], chunks, 8)
    ws = wf.reshape(*wf.shape[:-1], chunks, 8)
    acc = torch.zeros((*prod_shape[:-1], chunks), dtype=torch.float32, device=x.device)
    for j in range(8):
        acc = acc + xs[..., j] * ws[..., j]
    p = 1
    while p < chunks:
        p *= 2
    acc = torch.nn.functional.pad(acc, (0, p - chunks))
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc[..., 0]


def tree_order_case(device=None):
    """Head-decode inputs whose mask depends on the order of the channel
    sums: image 0's x holds 1, 2^-24 and -1 at the starts of its three
    8-channel chunks, image 1's low the same, everything else 0, all weights
    1 and no bias. In the tree order, (1 + 2^-24) + (-1 + 0) = 0, so every
    score is 0 and the mask is empty; an order that adds -1 to 1 first keeps
    the 2^-24 and marks every pixel. Shapes: x (2, 10, 8, 24), low (2, 20,
    16, 24), out 160x128. Returns (x, gw, low, w_lo, bias, out_h, out_w)."""
    x = torch.zeros((2, 10, 8, 24))
    low = torch.zeros((2, 20, 16, 24))
    for t, img in ((x, 0), (low, 1)):
        t[img, ..., 0], t[img, ..., 8], t[img, ..., 16] = 1.0, 2.0 ** -24, -1.0
    return (x.to(device, torch.bfloat16), torch.ones((2, 24), device=device),
            low.to(device, torch.bfloat16), torch.ones(24, device=device),
            torch.zeros((), device=device), 160, 128)


def fused_head_decode_plain(x: torch.Tensor, gw: torch.Tensor, low: torch.Tensor,
                            w_lo: torch.Tensor, bias, out_h: int, out_w: int) -> torch.Tensor:
    """The kernel's operations in the kernel's order: tree-order channel
    sums (:func:`_tree_channel_sum`), ``w0*a + w1*b`` lerps rows then
    columns, ``(up + ls) + bias``."""
    _check_head(x, gw, low, w_lo)
    hs = _tree_channel_sum(x, gw)
    ls = _tree_channel_sum(low, w_lo)
    up = _lerp_taps(hs, low.shape[1], low.shape[2])
    bias = torch.as_tensor(bias, dtype=torch.float32, device=x.device)
    return fused_mask_decode_plain((up + ls) + bias, out_h, out_w)


def fused_head_decode(x: torch.Tensor, gw: torch.Tensor, low: torch.Tensor,
                      w_lo: torch.Tensor, bias, out_h: int, out_w: int) -> torch.Tensor:
    """x (B, h16, w16, C) cbr features, gw (B, C) float32 gate times the
    high classifier's card-minus-background weights, low (B, h8, w8, Cl)
    low tap, w_lo (Cl,) and bias () float32 -> (B, out_h, out_w) uint8
    {0,1}. Launches the CUDA kernel for CUDA tensors (x and low bfloat16, C
    and Cl multiples of 8, C up to 256, Cl up to 64); CPU tensors take the
    plain version."""
    if x.device.type == "cpu":
        return fused_head_decode_plain(x, gw, low, w_lo, bias, out_h, out_w)
    with _HEAD_DECODE:
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        _check_head(x, gw, low, w_lo)
        if x.dtype != torch.bfloat16 or low.dtype != torch.bfloat16:
            raise ValueError(f"want bfloat16 x and low, got {x.dtype} and {low.dtype}")
        if gw.dtype != torch.float32 or w_lo.dtype != torch.float32:
            raise ValueError(f"want float32 gw and w_lo, got {gw.dtype} and {w_lo.dtype}")
        b, h16, w16, c = x.shape
        _, h8, w8, cl = low.shape
        if c % 8 or cl % 8 or not (8 <= c <= 256 and 8 <= cl <= 64):
            raise ValueError(f"want channel counts that are multiples of 8, C up to 256 and Cl up "
                             f"to 64, got {c} and {cl}")
        if not (x.is_contiguous() and low.is_contiguous()):
            raise ValueError("want contiguous NHWC tensors")
        dev = x.device
        gw, w_lo = gw.contiguous(), w_lo.contiguous()
        bias = torch.as_tensor(bias, dtype=torch.float32, device=dev).reshape(1)
        plan, bands, _, tap_ptrs = _head_launch(
            (b, h16, w16, c, h8, w8, cl, out_h, out_w, _build.sm_count(dev)), dev)
        out = torch.empty((b, out_h, out_w), dtype=torch.uint8, device=dev)
        fn = _build.bind("decoder", "mtg_fused_head_decode", _HEAD_ARGS)
        err = fn(x.data_ptr(), gw.data_ptr(), low.data_ptr(), w_lo.data_ptr(),
                 bias.data_ptr(), ctypes.cast(tap_ptrs, ctypes.c_void_p), bands.data_ptr(),
                 out.data_ptr(), b, h16, w16, c, h8, w8, cl, out_h, out_w, plan["n_bands"],
                 plan["band_rows"], plan["max_hs_rows"], plan["max_s8_rows"],
                 plan["gx"], plan["gy"], plan["smem_bytes"], _build.stream_ptr(x))
        _build.check(err, "fused_head_decode")
        _build.count("fused_head_decode")
        return out


# --------------------------------------------------------------------------
# upsample2x_add
# --------------------------------------------------------------------------


def _check_upsample(high: torch.Tensor, low: torch.Tensor) -> None:
    if high.dim() != 4 or tuple(low.shape) != (
            high.shape[0], 2 * high.shape[1], 2 * high.shape[2], high.shape[3]):
        raise ValueError(f"want (B, h, w, C) and (B, 2h, 2w, C), got "
                         f"{tuple(high.shape)} and {tuple(low.shape)}")


def _up2x(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Half-pixel bilinear 2x along ``dim``: even outputs 0.25*prev +
    0.75*x, odd outputs 0.75*x + 0.25*next, the edge clamped."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device)
    prev = x.index_select(dim, (idx - 1).clamp(min=0))
    nxt = x.index_select(dim, (idx + 1).clamp(max=n - 1))
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    shape = list(x.shape)
    shape[dim] = 2 * n
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def upsample2x_add_plain(high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """Rows, then columns, in float32, plus ``low``, cast to ``low``'s
    dtype."""
    _check_upsample(high, low)
    up = _up2x(_up2x(high.float(), 1), 2)
    return (up + low.float()).to(low.dtype)


def upsample2x_add(high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) + (B, 2h, 2w, C) -> (B, 2h, 2w, C) in ``low``'s dtype:
    exact half-pixel bilinear 2x upsample of ``high``, plus ``low``.
    Launches the CUDA kernel for CUDA tensors (both float32 or both
    bfloat16, C a multiple of 4 or 8); CPU tensors take the plain
    version."""
    if high.device.type == "cpu":
        return upsample2x_add_plain(high, low)
    if high.device.type != "cuda":
        raise ValueError(f"unsupported device {high.device}")
    _check_upsample(high, low)
    if high.dtype != low.dtype or low.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"want both float32 or both bfloat16, got {high.dtype} and "
                         f"{low.dtype}")
    b, h, w, c = high.shape
    if c % (8 if low.dtype == torch.bfloat16 else 4):
        raise ValueError(f"channel count {c} is not a multiple of the 16-byte vector")
    if not (high.is_contiguous() and low.is_contiguous()):
        raise ValueError("want contiguous NHWC tensors")
    out = torch.empty_like(low)
    fn = _build.bind("decoder", "mtg_upsample2x_add", _UP_ARGS)
    err = fn(high.data_ptr(), low.data_ptr(), out.data_ptr(),
             int(low.dtype == torch.bfloat16), b, h, w, c, _build.stream_ptr(high))
    _build.check(err, "upsample2x_add")
    _build.count("upsample2x_add")
    return out
