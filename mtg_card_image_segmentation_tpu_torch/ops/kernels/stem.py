"""Stem kernel (counterpart of the JAX package's ``ops/pallas/stem.py::
fused_stem``).

(B, H, W, 3) uint8 -> ``hardswish(conv3x3 stride 2 pad 1 (u8 - center) * W'
+ b)``, 3 -> 16 channels: the serving stem with BatchNorm and the ImageNet
normalization folded into the weights, so the input is only centered, and
zero padding of the centered image stands for a normalized 0. One read of
the bytes, one write of the (B, H/2, W/2, 16) result. The CUDA kernel is
``csrc/stem.cu`` (a direct stencil); :func:`fused_stem_plain` is its plain
PyTorch version and the wrapper takes it only for CPU tensors.

Arithmetic, that of the TPU kernel: the centered input is ``bf16(u8) -
bf16(center)`` computed in bf16, the weights are rounded to bf16, products
accumulate in float32 (taps in (ky, kx, c) order), bias and hardswish in
float32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 4 + [_P]
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_ONE_SIXTH = float(np.float32(1.0) / np.float32(6.0))
COUT = 16


def _check(images_u8, kernel, bias, center, out_dtype) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(
            f"want (B, H, W, 3) uint8, got {tuple(images_u8.shape)} {images_u8.dtype}")
    if images_u8.shape[1] % 8 or images_u8.shape[2] % 8:
        raise ValueError(f"H and W must be multiples of 8, got {tuple(images_u8.shape)}")
    if tuple(kernel.shape) != (3, 3, 3, COUT) or tuple(bias.shape) != (COUT,) \
            or tuple(center.shape) != (3,):
        raise ValueError(
            f"want a (3, 3, 3, {COUT}) HWIO kernel, ({COUT},) bias and (3,) center, got "
            f"{tuple(kernel.shape)}, {tuple(bias.shape)}, {tuple(center.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def _operands(kernel, bias, center):
    """The float32 operands both versions compute with: the (27, 16) weights
    and the center, each rounded to bf16, and the bias."""
    w = kernel.to(torch.bfloat16).float().reshape(27, COUT).contiguous()
    return w, bias.float().contiguous(), center.to(torch.bfloat16).float().contiguous()


def fused_stem_plain(images_u8: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     center: torch.Tensor,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in stock ops: 27 shifted, strided views of
    the zero-padded centered image, each times its weight row, summed in
    tap order in float32."""
    _check(images_u8, kernel, bias, center, out_dtype)
    w, b, c = _operands(kernel, bias, center)
    _, h, wd, _ = images_u8.shape
    x = (images_u8.to(torch.bfloat16) - c.to(torch.bfloat16)).float()
    x = F.pad(x, (0, 0, 1, 1, 1, 1))  # zeros around the centered image
    acc = None
    for ky in range(3):
        for kx in range(3):
            patch = x[:, ky:ky + h:2, kx:kx + wd:2, :]  # (B, H/2, W/2, 3)
            for ch in range(3):
                term = patch[..., ch:ch + 1] * w[(ky * 3 + kx) * 3 + ch]
                acc = term if acc is None else acc + term
    y = acc + b
    y = y * (torch.clamp(y + 3.0, 0.0, 6.0) * _ONE_SIXTH)
    return y.to(out_dtype)


def fused_stem(images_u8: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               center: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8, H and W multiples of 8, with the (3, 3, 3, 16)
    HWIO kernel, (16,) bias and (3,) center -> (B, H/2, W/2, 16)
    ``out_dtype``. Launches the CUDA kernel for a CUDA tensor; a CPU tensor
    takes the plain version."""
    if images_u8.device.type == "cpu":
        return fused_stem_plain(images_u8, kernel, bias, center, out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {images_u8.device}")
    _check(images_u8, kernel, bias, center, out_dtype)
    if not images_u8.is_contiguous():
        raise ValueError("want a contiguous NHWC tensor")
    if not (kernel.device == bias.device == center.device == images_u8.device):
        raise ValueError("kernel, bias and center must lie on the images' device")
    w, b, c = _operands(kernel, bias, center)
    n, h, wd, _ = images_u8.shape
    out = torch.empty((n, h // 2, wd // 2, COUT), dtype=out_dtype, device=images_u8.device)
    fn = _build.bind("stem", "mtg_fused_stem", _ARGS)
    err = fn(images_u8.data_ptr(), w.data_ptr(), b.data_ptr(), c.data_ptr(),
             out.data_ptr(), int(out_dtype == torch.bfloat16), n, h, wd,
             _build.stream_ptr(images_u8))
    _build.check(err, "fused_stem")
    _build.count("fused_stem")
    return out
