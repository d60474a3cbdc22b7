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

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 10 + [_I] * 9 + [_P]
_HEAD_ARGS = [_P] * 8 + [_I] * 13 + [_P]
_UP_ARGS = [_P] * 3 + [_I] * 5 + [_P]
_BAND_ROWS = 64  # output rows per CTA of the head decode

_TAPS: Dict[Tuple[int, int, str], Tuple[torch.Tensor, ...]] = {}
_CACHE_LOCK = threading.Lock()  # the per-shape tables fill once, from any thread


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
    (those rows and the band's row-lerped rows, float32) and the block
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
            "smem_bytes": 4 * (src_rows + band_rows) * w, "gx": gx, "gy": max(1, 128 // gx),
            "groups": groups}


def fused_mask_decode(scores: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, h, w) float32 -> (B, out_h, out_w) uint8 {0,1}. Launches the
    CUDA kernel for a CUDA tensor; a CPU tensor takes the plain version."""
    if scores.device.type == "cpu":
        return fused_mask_decode_plain(scores, out_h, out_w)
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

_BANDS: Dict[Tuple, Tuple[torch.Tensor, int, int, int]] = {}


def _head_bands(h16: int, h8: int, out_h: int, device: torch.device):
    """The head decode's row bands: an int32 (n, 4) table on ``device`` of
    (s8_row0, s8_rows, hs_row0, hs_rows) per band of ``_BAND_ROWS`` output
    rows (the stride-8 and stride-16 rows the band's lerps read), with the
    number of bands and the largest hs and s8 row counts. Cached per
    shape."""
    key = (h16, h8, out_h, str(device))
    with _CACHE_LOCK:
        if key not in _BANDS:
            lo_v, hi_v, _, _ = _interp_taps(h8, out_h)
            lo_u, hi_u, _, _ = _interp_taps(h16, h8)
            rows = []
            for r0 in range(0, out_h, _BAND_ROWS):
                r1 = min(r0 + _BAND_ROWS, out_h) - 1
                s0, s1 = int(lo_v[r0]), int(hi_v[r1])
                t0, t1 = int(lo_u[s0]), int(hi_u[s1])
                rows.append((s0, s1 - s0 + 1, t0, t1 - t0 + 1))
            table = np.asarray(rows, np.int32)
            _BANDS[key] = (torch.from_numpy(table).to(device), len(rows),
                           int(table[:, 3].max()), int(table[:, 1].max()))
        return _BANDS[key]


def _check_head(x, gw, low, w_lo) -> None:
    if x.dim() != 4 or low.dim() != 4 or x.shape[0] != low.shape[0]:
        raise ValueError(f"want (B, h16, w16, C) and (B, h8, w8, Cl), got "
                         f"{tuple(x.shape)} and {tuple(low.shape)}")
    if tuple(gw.shape) != (x.shape[0], x.shape[3]) or tuple(w_lo.shape) != (low.shape[3],):
        raise ValueError(f"want gw (B, C) and w_lo (Cl,), got {tuple(gw.shape)} and "
                         f"{tuple(w_lo.shape)}")


def _seq_channel_sum(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """sum_c x[..., c] * weight[..., c] in float32, channels in ascending
    order, each product and each partial sum rounded on its own. ``weight``
    is (C,) or (B, C)."""
    xf = x.float()
    wf = weight.float()
    if wf.dim() == 2:
        wf = wf[:, None, None, :]
    acc = torch.zeros(xf.shape[:-1], dtype=torch.float32, device=x.device)
    for c in range(xf.shape[-1]):
        acc = acc + xf[..., c] * wf[..., c]
    return acc


def fused_head_decode_plain(x: torch.Tensor, gw: torch.Tensor, low: torch.Tensor,
                            w_lo: torch.Tensor, bias, out_h: int, out_w: int) -> torch.Tensor:
    """The kernel's operations in the kernel's order: sequential channel
    sums, ``w0*a + w1*b`` lerps rows then columns, ``(up + ls) + bias``."""
    _check_head(x, gw, low, w_lo)
    hs = _seq_channel_sum(x, gw)
    ls = _seq_channel_sum(low, w_lo)
    up = _lerp_taps(hs, low.shape[1], low.shape[2])
    bias = torch.as_tensor(bias, dtype=torch.float32, device=x.device)
    return fused_mask_decode_plain((up + ls) + bias, out_h, out_w)


def fused_head_decode(x: torch.Tensor, gw: torch.Tensor, low: torch.Tensor,
                      w_lo: torch.Tensor, bias, out_h: int, out_w: int) -> torch.Tensor:
    """x (B, h16, w16, C) cbr features, gw (B, C) float32 gate times the
    high classifier's card-minus-background weights, low (B, h8, w8, Cl)
    low tap, w_lo (Cl,) and bias () float32 -> (B, out_h, out_w) uint8
    {0,1}. Launches the CUDA kernel for CUDA tensors (x and low bfloat16, C
    and Cl multiples of 8); CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return fused_head_decode_plain(x, gw, low, w_lo, bias, out_h, out_w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_head(x, gw, low, w_lo)
    if x.dtype != torch.bfloat16 or low.dtype != torch.bfloat16:
        raise ValueError(f"want bfloat16 x and low, got {x.dtype} and {low.dtype}")
    if gw.dtype != torch.float32 or w_lo.dtype != torch.float32:
        raise ValueError(f"want float32 gw and w_lo, got {gw.dtype} and {w_lo.dtype}")
    b, h16, w16, c = x.shape
    _, h8, w8, cl = low.shape
    if c % 8 or cl % 8:
        raise ValueError(f"channel counts must be multiples of 8, got {c} and {cl}")
    if not (x.is_contiguous() and low.is_contiguous()):
        raise ValueError("want contiguous NHWC tensors")
    dev = x.device
    gw, w_lo = gw.contiguous(), w_lo.contiguous()
    bias = torch.as_tensor(bias, dtype=torch.float32, device=dev).reshape(1)
    taps = (interp_taps(h16, h8, dev) + interp_taps(w16, w8, dev)
            + interp_taps(h8, out_h, dev) + interp_taps(w8, out_w, dev))
    tap_ptrs = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in taps))
    bands, n_bands, max_hs, max_s8 = _head_bands(h16, h8, out_h, dev)
    out = torch.empty((b, out_h, out_w), dtype=torch.uint8, device=dev)
    fn = _build.bind("decoder", "mtg_fused_head_decode", _HEAD_ARGS)
    err = fn(x.data_ptr(), gw.data_ptr(), low.data_ptr(), w_lo.data_ptr(),
             bias.data_ptr(), ctypes.cast(tap_ptrs, ctypes.c_void_p), bands.data_ptr(),
             out.data_ptr(), b, h16, w16, c, h8, w8, cl, out_h, out_w, n_bands,
             _BAND_ROWS, max_hs, max_s8, _build.stream_ptr(x))
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
