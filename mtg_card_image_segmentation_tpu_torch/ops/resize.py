"""Half-pixel (align_corners=False) bilinear resize, NHWC, no antialiasing.

Same formulation as the JAX package's ``ops/resize.py``: separable, gather +
lerp along H, then along W, in float32, ``a + (b - a) * w``. That is the
arithmetic the mask decode kernel (``ops/kernels/decoder.py``) repeats
bit for bit.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def half_pixel_coords(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, w_hi) for half-pixel linear interpolation, in float32 like
    the JAX reference: src = (dst + 0.5) * (in/out) - 0.5, clamped to
    [0, in-1]."""
    scale = np.float32(in_size / out_size)
    dst = np.arange(out_size, dtype=np.float32)
    src = np.clip((dst + np.float32(0.5)) * scale - np.float32(0.5),
                  np.float32(0.0), np.float32(in_size - 1)).astype(np.float32)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1).astype(np.int32)
    w_hi = (src - lo.astype(np.float32)).astype(np.float32)
    return lo, hi, w_hi


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out, in) half-pixel bilinear interpolation matrix (2 nonzeros
    per row), built in float64 and cast to float32 (copy of the JAX
    package's ``ops/pallas/decoder.py::_interp_matrix``)."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) * scale - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo] += (1.0 - w_hi).astype(np.float32)
    m[np.arange(out_size), hi] += w_hi.astype(np.float32)
    return m


def _interp_taps(in_size: int, out_size: int):
    """The two taps of each row of :func:`_interp_matrix`: (lo, hi) int32
    indices and (w0, w1) float32 weights, from the same float64 math, so
    ``m[r, lo] * a + m[r, hi] * b == w0 * a + w1 * b`` (where lo == hi the
    matrix holds w0 + w1 = 1 with w1 = 0)."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) * scale - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    return (lo.astype(np.int32), hi.astype(np.int32),
            (1.0 - w_hi).astype(np.float32), w_hi.astype(np.float32))


@lru_cache(maxsize=64)
def _device_coords(in_size: int, out_size: int, device: torch.device):
    """:func:`half_pixel_coords` as (lo, hi) int64 and w_hi float32 tensors
    on ``device``, made once: a copy from host memory on every call would
    wait for the device each time. They are made outside inference mode,
    so that a first call under ``torch.inference_mode`` (a predictor) does
    not cache tensors that autograd (training) refuses to save. A trace
    (``torch.export``) takes :func:`_coords` instead, which caches nothing:
    the tensors it makes are the trace's fakes."""
    return _coords(in_size, out_size, device)


def _coords(in_size: int, out_size: int, device: torch.device):
    lo, hi, w = half_pixel_coords(in_size, out_size)
    with torch.inference_mode(False):
        return (torch.from_numpy(lo.astype(np.int64)).to(device),
                torch.from_numpy(hi.astype(np.int64)).to(device),
                torch.from_numpy(w).to(device))


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize NHWC (or HWC) ``x`` to (out_h, out_w): torch
    ``F.interpolate(mode='bilinear', align_corners=False)`` semantics,
    computed in float32 and cast back to ``x.dtype``."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, in_h, in_w, _ = x.shape
    xf = x.float()
    coords = _coords if torch.compiler.is_compiling() else _device_coords
    if in_h != out_h:
        lo, hi, w = coords(in_h, out_h, x.device)
        top = xf.index_select(1, lo)
        bot = xf.index_select(1, hi)
        xf = top + (bot - top) * w[None, :, None, None]
    if in_w != out_w:
        lo, hi, w = coords(in_w, out_w, x.device)
        left = xf.index_select(2, lo)
        right = xf.index_select(2, hi)
        xf = left + (right - left) * w[None, None, :, None]
    out = xf.to(x.dtype)
    return out[0] if squeeze else out


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output position for :func:`nearest_resize`:
    ``min(int(float32(dst) * float32(in/out)), in - 1)``, the float32
    arithmetic of the JAX reference."""
    dst = np.arange(out_size, dtype=np.float32)
    idx = (dst * np.float32(in_size / out_size)).astype(np.int32)
    return np.minimum(idx, in_size - 1).astype(np.int64)


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC (or HWC) ``x``, src = floor(dst *
    in/out), as an explicit gather with the reference's index rule (which
    ``F.interpolate(mode='nearest')`` is not promised to share at
    non-integer ratios)."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, in_h, in_w, _ = x.shape
    idx_h = torch.from_numpy(nearest_indices(in_h, out_h)).to(x.device)
    idx_w = torch.from_numpy(nearest_indices(in_w, out_w)).to(x.device)
    out = x.index_select(1, idx_h).index_select(2, idx_w)
    return out[0] if squeeze else out


def upsample_add(high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """Bilinear-upsample NHWC ``high`` to ``low``'s spatial size and add:
    the LR-ASPP decoder merge (reference train/model.py:140-142). The
    hand-written variant is ``ops/kernels/decoder.py::upsample2x_add``."""
    _, h, w, _ = low.shape
    return bilinear_resize(high, h, w) + low
