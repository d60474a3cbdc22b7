"""Stem kernel (counterpart of the JAX package's ``ops/pallas/stem.py::
fused_stem``).

(B, H, W, 3) uint8 -> ``hardswish(conv3x3 stride 2 pad 1 (u8 - center) * W'
+ b)``, 3 -> 16 channels: the serving stem with BatchNorm and the ImageNet
normalization folded into the weights, so the input is only centered, and
zero padding of the centered image stands for a normalized 0. One read of
the bytes, one write of the (B, H/2, W/2, 16) result. The CUDA kernel is
``csrc/stem.cu``, an implicit GEMM on the tensor cores whose operands
:func:`prepare_stem` makes once (the predictor keeps them);
:func:`apply_stem_plain` is its plain PyTorch version and :func:`apply_stem`
takes it only for CPU tensors. :func:`fused_stem` and
:func:`fused_stem_plain` take the HWIO kernel, bias and center directly.

Arithmetic, that of the TPU kernel: the centered input is ``bf16(u8) -
bf16(center)`` computed in bf16, the weights are rounded to bf16, products
accumulate in float32, bias and hardswish in float32. The plain version
sums the 27 products in (ky, kx, c) order; the tensor cores sum them in
their own, so the kernel agrees with it within fp32 rounding of the sums,
which can move a bf16 output by one unit in the last place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
from mtg_card_image_segmentation_tpu_torch.utils.profiling import Span

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 7 + [_P]
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_ONE_SIXTH = float(np.float32(1.0) / np.float32(6.0))
COUT = 16
_STEM = Span("kernel.apply_stem", "kernels")

# the kernel's tiling (csrc/stem.cu): 16 x 64 output pixels per tile, 256
# threads, a 33-row window, three CTAs per multiprocessor
TILE_H, TILE_W, THREADS, CTAS_PER_SM = 16, 64, 256, 3
_WIN_ROWS = 2 * TILE_H + 1


def k_taps() -> np.ndarray:
    """The kernel's K layout: for each of its 32 K rows, the tap index
    ``(ky * 3 + kx) * 3 + c`` whose weight the row holds, or -1 for a zero
    row. Pair ``q = 5 * ky + j`` (K rows ``2q``, ``2q + 1``) covers the
    values at positions ``2j - 1`` and ``2j`` of tap row ``ky``, each
    position being ``kx * 3 + c``; position -1 and the 16th pair have zero
    weight."""
    taps = np.full(32, -1, np.int64)
    for q in range(15):
        ky, j = divmod(q, 5)
        for s in range(2):
            pos = 2 * j - 1 + s
            if 0 <= pos <= 8:
                taps[2 * q + s] = 9 * ky + pos
    return taps


class StemOperands(NamedTuple):
    """What the stem computes with, made once from the HWIO kernel: the
    (27, 16) weights rounded to bf16 (as float32, for the plain version),
    the kernel's B as (16, 16) int32 pairs of bf16 (K rows laid out by
    :func:`k_taps`, pair ``q`` of channel ``n`` at ``[q, n]``, the even K
    row in the low half), the float32 bias and the bf16-rounded center."""
    w27: torch.Tensor
    pairs: torch.Tensor
    bias: torch.Tensor
    center: torch.Tensor


def _check_images(images_u8, out_dtype) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(
            f"want (B, H, W, 3) uint8, got {tuple(images_u8.shape)} {images_u8.dtype}")
    if images_u8.shape[1] % 8 or images_u8.shape[2] % 8:
        raise ValueError(f"H and W must be multiples of 8, got {tuple(images_u8.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def prepare_stem(kernel: torch.Tensor, bias: torch.Tensor,
                 center: torch.Tensor) -> StemOperands:
    """The (3, 3, 3, 16) HWIO kernel, (16,) bias and (3,) center as the
    stem's operands, on the kernel's device."""
    if tuple(kernel.shape) != (3, 3, 3, COUT) or tuple(bias.shape) != (COUT,) \
            or tuple(center.shape) != (3,):
        raise ValueError(
            f"want a (3, 3, 3, {COUT}) HWIO kernel, ({COUT},) bias and (3,) center, got "
            f"{tuple(kernel.shape)}, {tuple(bias.shape)}, {tuple(center.shape)}")
    w27 = kernel.to(torch.bfloat16).float().reshape(27, COUT).contiguous()
    taps = torch.from_numpy(k_taps()).to(kernel.device)
    b = torch.where((taps >= 0)[:, None], w27[taps.clamp(min=0)], 0.0).to(torch.bfloat16)
    pairs = b.reshape(16, 2, COUT).permute(0, 2, 1).contiguous().view(torch.int32)
    return StemOperands(w27, pairs.reshape(16, COUT), bias.float().contiguous(),
                        center.to(torch.bfloat16).float().contiguous())


def stem_preact_plain(images_u8: torch.Tensor, ops: StemOperands) -> torch.Tensor:
    """The float32 sums before bias and activation: 27 shifted, strided
    views of the zero-padded centered image, each times its weight row,
    summed in tap order (ky, kx, c)."""
    _, h, wd, _ = images_u8.shape
    x = (images_u8.to(torch.bfloat16) - ops.center.to(torch.bfloat16)).float()
    x = F.pad(x, (0, 0, 1, 1, 1, 1))  # zeros around the centered image
    acc = None
    for ky in range(3):
        for kx in range(3):
            patch = x[:, ky:ky + h:2, kx:kx + wd:2, :]  # (B, H/2, W/2, 3)
            for ch in range(3):
                term = patch[..., ch:ch + 1] * ops.w27[(ky * 3 + kx) * 3 + ch]
                acc = term if acc is None else acc + term
    return acc


def apply_stem_plain(images_u8: torch.Tensor, ops: StemOperands,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain version on prepared operands: :func:`stem_preact_plain`,
    then bias and hardswish in float32."""
    _check_images(images_u8, out_dtype)
    y = stem_preact_plain(images_u8, ops) + ops.bias
    y = y * (torch.clamp(y + 3.0, 0.0, 6.0) * _ONE_SIXTH)
    return y.to(out_dtype)


@functools.lru_cache(maxsize=64)
def stem_plan(b: int, h: int, w: int, sm_count: int, out_bytes: int = 2,
              aligned16: bool = True) -> Dict[str, int]:
    """The stem's launch plan: the window's load width (16-byte words when
    an image row, ``3 * w`` bytes, is a multiple of 16 and the images are
    16-byte aligned, else 4-byte words), the tile count, the persistent
    grid (``CTAS_PER_SM`` per multiprocessor, at most one per tile) and the
    shared bytes: two raw windows, the centered bf16 window and each warp's
    16-pixel staging row of ``out_bytes``-byte values, each region rounded
    up to 16 bytes."""
    vec = 16 if w % 16 == 0 and aligned16 else 4
    pre = 13 if vec == 16 else 1
    row = -(-(6 * TILE_W + 3 + pre) // vec) * vec
    r16 = lambda n: -(-n // 16) * 16  # noqa: E731
    ho, wo = h // 2, w // 2
    n_tiles = b * -(-ho // TILE_H) * -(-wo // TILE_W)
    smem = 2 * r16(_WIN_ROWS * row) + r16(2 * _WIN_ROWS * row) \
        + (THREADS // 32) * 16 * COUT * out_bytes
    return {"vec_bytes": vec, "pre": pre, "row_elems": row, "n_tiles": n_tiles,
            "grid": min(n_tiles, CTAS_PER_SM * sm_count), "smem_bytes": smem}


def apply_stem(images_u8: torch.Tensor, ops: StemOperands,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8, H and W multiples of 8, with operands from
    :func:`prepare_stem` -> (B, H/2, W/2, 16) ``out_dtype``. Launches the
    CUDA kernel for a CUDA tensor; a CPU tensor takes the plain version."""
    if images_u8.device.type == "cpu":
        return apply_stem_plain(images_u8, ops, out_dtype)
    with _STEM:
        if images_u8.device.type != "cuda":
            raise ValueError(f"unsupported device {images_u8.device}")
        _check_images(images_u8, out_dtype)
        if not images_u8.is_contiguous():
            raise ValueError("want a contiguous NHWC tensor")
        if any(t.device != images_u8.device for t in ops):
            raise ValueError("the stem's operands must lie on the images' device")
        n, h, wd, _ = images_u8.shape
        plan = stem_plan(n, h, wd, _build.sm_count(images_u8.device),
                         out_dtype.itemsize, images_u8.data_ptr() % 16 == 0)
        out = torch.empty((n, h // 2, wd // 2, COUT), dtype=out_dtype, device=images_u8.device)
        fn = _build.bind("stem", "mtg_fused_stem", _ARGS)
        err = fn(images_u8.data_ptr(), ops.pairs.data_ptr(), ops.bias.data_ptr(),
                 ops.center.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16), n, h, wd,
                 plan["vec_bytes"], plan["grid"], plan["smem_bytes"],
                 _build.stream_ptr(images_u8))
        _build.check(err, "fused_stem")
        _build.count("fused_stem")
        return out


def fused_stem_plain(images_u8: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     center: torch.Tensor,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`apply_stem_plain` on operands made from the HWIO kernel."""
    return apply_stem_plain(images_u8, prepare_stem(kernel, bias, center), out_dtype)


def fused_stem(images_u8: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               center: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8, H and W multiples of 8, with the (3, 3, 3, 16)
    HWIO kernel, (16,) bias and (3,) center -> (B, H/2, W/2, 16)
    ``out_dtype``: :func:`apply_stem` on operands made for this call (a
    caller that runs the stem often prepares them once)."""
    return apply_stem(images_u8, prepare_stem(kernel, bias, center), out_dtype)
