"""Mask decode kernel (counterpart of the JAX package's
``ops/pallas/decoder.py::fused_mask_decode``).

(B, h, w) float32 card-minus-background score -> (B, H, W) uint8 mask,
``bilinear_resize(score) > 0``, which equals ``argmax`` of the resized
two-class logits because the resize is linear. The CUDA kernel is
``csrc/decoder.cu``; :func:`fused_mask_decode_plain` is its plain PyTorch
version, bit-equal to it, and the wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
from mtg_card_image_segmentation_tpu_torch.ops.resize import _interp_taps

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 10 + [_I] * 5 + [_P]

_TAPS: Dict[Tuple[int, int, str], Tuple[torch.Tensor, ...]] = {}


def interp_taps(in_size: int, out_size: int, device: torch.device):
    """(lo, hi, w0, w1) tensors on ``device``, cached per shape."""
    key = (in_size, out_size, str(device))
    if key not in _TAPS:
        _TAPS[key] = tuple(torch.from_numpy(a).to(device)
                           for a in _interp_taps(in_size, out_size))
    return _TAPS[key]


def fused_mask_decode_plain(scores: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Row lerp, then column lerp, ``w0*a + w1*b`` each, then ``> 0``."""
    _, h, w = scores.shape
    lo_h, hi_h, w0_h, w1_h = interp_taps(h, out_h, scores.device)
    lo_w, hi_w, w0_w, w1_w = interp_taps(w, out_w, scores.device)
    x = scores.float()
    up = w0_h[:, None] * x[:, lo_h.long(), :] + w1_h[:, None] * x[:, hi_h.long(), :]
    full = w0_w * up[:, :, lo_w.long()] + w1_w * up[:, :, hi_w.long()]
    return (full > 0.0).to(torch.uint8)


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
    taps_h = interp_taps(h, out_h, scores.device)
    taps_w = interp_taps(w, out_w, scores.device)
    out = torch.empty((b, out_h, out_w), dtype=torch.uint8, device=scores.device)
    fn = _build.bind("decoder", "mtg_fused_mask_decode", _ARGS)
    err = fn(scores.data_ptr(), *(t.data_ptr() for t in taps_h),
             *(t.data_ptr() for t in taps_w), out.data_ptr(),
             b, h, w, out_h, out_w, _build.stream_ptr(scores))
    _build.check(err, "fused_mask_decode")
    _build.count("fused_mask_decode")
    return out
