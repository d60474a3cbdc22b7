"""uint8 -> normalized float kernel (counterpart of the JAX package's
``ops/pallas/preprocess.py::fused_normalize``).

(B, H, W, 3) uint8 -> ``x * scale_c + shift_c`` with ``scale = 1/(255 std)``
and ``shift = -mean/std`` (ImageNet constants), float32 math, float32 or
bfloat16 out: one read of the bytes and one write of the result. The CUDA
kernel is ``csrc/preprocess.cu``; :func:`fused_normalize_plain` is its plain
PyTorch version, bit-equal to it, and the wrapper takes it only for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.data.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
from mtg_card_image_segmentation_tpu_torch.utils.profiling import Span

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, ctypes.c_longlong, _I] + [_F] * 6 + [_P]
_OUT_DTYPES = (torch.float32, torch.bfloat16)

# float32 arithmetic, as the reference builds its constants
_STD = np.asarray(IMAGENET_STD, np.float32)
SCALE = (np.float32(1.0) / (np.float32(255.0) * _STD)).astype(np.float32)
SHIFT = (-np.asarray(IMAGENET_MEAN, np.float32) / _STD).astype(np.float32)
_NORMALIZE = Span("kernel.fused_normalize", "kernels")


def _check(images_u8: torch.Tensor, out_dtype: torch.dtype) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(
            f"want (B, H, W, 3) uint8, got {tuple(images_u8.shape)} {images_u8.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def fused_normalize_plain(images_u8: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x.float() * scale + shift`` (a product, then a sum: two float32
    roundings), then the cast."""
    _check(images_u8, out_dtype)
    scale = torch.from_numpy(SCALE).to(images_u8.device)
    shift = torch.from_numpy(SHIFT).to(images_u8.device)
    return (images_u8.float() * scale + shift).to(out_dtype)


def fused_normalize(images_u8: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> ImageNet-normalized (B, H, W, 3) ``out_dtype``.
    Launches the CUDA kernel for a CUDA tensor; a CPU tensor takes the plain
    version."""
    if images_u8.device.type == "cpu":
        return fused_normalize_plain(images_u8, out_dtype)
    with _NORMALIZE:
        if images_u8.device.type != "cuda":
            raise ValueError(f"unsupported device {images_u8.device}")
        _check(images_u8, out_dtype)
        if not images_u8.is_contiguous():
            raise ValueError("want a contiguous NHWC tensor")
        out = torch.empty(images_u8.shape, dtype=out_dtype, device=images_u8.device)
        fn = _build.bind("preprocess", "mtg_fused_normalize", _ARGS)
        err = fn(images_u8.data_ptr(), out.data_ptr(), images_u8.numel(),
                 int(out_dtype == torch.bfloat16), *map(float, SCALE), *map(float, SHIFT),
                 _build.stream_ptr(images_u8))
        _build.check(err, "fused_normalize")
        _build.count("fused_normalize")
        return out
