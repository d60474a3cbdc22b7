"""Stencil-floor microbenchmark function (counterpart of the kernel body of
the JAX package's ``tools/vpu_stencil_floor.py``).

``stencil_floor(x, w_exp, w_dw, mode)``: ``y = bf16(bf16(x) @ bf16(w_exp))``
with float32 accumulation, then per ``mode``

- ``pass``: ``acc = f32(y)`` (the expand product alone);
- ``arith``: the k*k-term chain ``sum f32(bf16(y * bf16(w_dw[ky*k+kx])))``
  on the unshifted ``y`` (same operations as the stencil, no window
  movement; wrong math on purpose, for timing);
- ``full``: the same sum with ``y`` shifted by ``((ky-p)*d, (kx-p)*d)`` and
  zero fill, columns outer and rows inner: the tail block's real stencil;

and the result is the mean of ``acc`` over the expanded channels, (B, H, W,
1) float32. ``full - pass`` is the stencil's cost and ``arith - pass`` its
arithmetic alone.

On the card each mode is one launch of ``csrc/stencil_floor.cu``; the
plain version below runs for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

MODES = ("pass", "arith", "full")
BF16 = torch.bfloat16
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 4 + [_I] * 8 + [_P]


def _check(x: torch.Tensor, w_exp: torch.Tensor, w_dw: torch.Tensor, mode: str,
           kernel_size: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; want one of {MODES}")
    if x.dim() != 4 or x.dtype != BF16:
        raise ValueError(f"want x (B, H, W, C) bfloat16, got {tuple(x.shape)} {x.dtype}")
    if w_exp.dtype != torch.float32 or w_exp.dim() != 2 or w_exp.shape[0] != x.shape[-1]:
        raise ValueError(f"want w_exp ({x.shape[-1]}, E) float32, got "
                         f"{tuple(w_exp.shape)} {w_exp.dtype}")
    if (w_dw.dtype != torch.float32
            or tuple(w_dw.shape) != (kernel_size * kernel_size, w_exp.shape[1])):
        raise ValueError(f"want w_dw ({kernel_size * kernel_size}, {w_exp.shape[1]}) "
                         f"float32, got {tuple(w_dw.shape)} {w_dw.dtype}")
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")


def stencil_floor_plain(x: torch.Tensor, w_exp: torch.Tensor, w_dw: torch.Tensor,
                        mode: str, kernel_size: int = 5, dilation: int = 2) -> torch.Tensor:
    """The function in plain PyTorch ops, at the TPU kernel's precision."""
    _check(x, w_exp, w_dw, mode, kernel_size)
    k, d = kernel_size, dilation
    _, h, w, _ = x.shape
    y = (x.float() @ w_exp.to(BF16).float()).to(BF16)
    if mode == "pass":
        acc = y.float()
    else:
        p = (k - 1) // 2 * d if mode == "full" else 0
        step = d if mode == "full" else 0
        yp = F.pad(y, (0, 0, p, p, p, p))
        taps = w_dw.to(BF16)
        acc = None
        for kx in range(k):
            for ky in range(k):
                win = yp[:, ky * step:ky * step + h, kx * step:kx * step + w, :]
                term = (win * taps[ky * k + kx]).float()  # bf16-rounded product
                acc = term if acc is None else acc + term
    return acc.mean(dim=-1, keepdim=True)


def stencil_floor(x: torch.Tensor, w_exp: torch.Tensor, w_dw: torch.Tensor,
                  mode: str, kernel_size: int = 5, dilation: int = 2) -> torch.Tensor:
    """x (B, H, W, C) bfloat16, w_exp (C, E) float32, w_dw (k*k, E) float32
    -> (B, H, W, 1) float32. One kernel launch for a CUDA tensor (W and C
    multiples of 16, E a multiple of 64); a CPU tensor takes the plain
    version."""
    if x.device.type == "cpu":
        return stencil_floor_plain(x, w_exp, w_dw, mode, kernel_size, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w_exp, w_dw, mode, kernel_size)
    if w_exp.device != x.device or w_dw.device != x.device:
        raise ValueError("x, w_exp and w_dw must lie on one device")
    b, h, w, c = x.shape
    e = w_exp.shape[1]
    if w % 16 or c % 16 or e % 64 or b > 65535:
        raise ValueError(f"kernel wants W and C multiples of 16 and E a multiple of 64, "
                         f"got W={w} C={c} E={e}")
    x, w_exp, w_dw = x.contiguous(), w_exp.contiguous(), w_dw.contiguous()
    out = torch.empty((b, h, w, 1), dtype=torch.float32, device=x.device)
    fn = _build.bind("stencil_floor", "mtg_stencil_floor", _ARGS)
    err = fn(x.data_ptr(), w_exp.data_ptr(), w_dw.data_ptr(), out.data_ptr(),
             b, h, w, c, e, kernel_size, dilation, MODES.index(mode),
             _build.stream_ptr(x))
    _build.check(err, f"stencil_floor[{mode}]")
    _build.count("stencil_floor")
    return out


# published peaks of one H100 SXM: HBM3 bytes/s, dense bf16 tensor-core
# flop/s, float32 flop/s outside the tensor cores
H100_HBM_BYTES_PER_S, H100_BF16_TENSOR_FLOPS, H100_FP32_FLOPS = 3.35e12, 989e12, 67e12


def bound_ms(shape, expanded: int, mode: str, kernel_size: int = 5):
    """(ms, "bytes" | "operations"): the least time an H100 could take for
    one call. Bytes: x, both weights and the output once over the HBM rate.
    Operations: the expand product on the tensor cores, and on the CUDA
    cores the term chain with the channel sum (per expanded value k*k
    multiplies, k*k - 1 adds and one add into the sum: 2*k*k; in ``pass``
    the one add into the sum); the two units run side by side."""
    b, h, w, c = shape
    n = b * h * w
    nbytes = n * c * 2 + c * expanded * 4 + kernel_size ** 2 * expanded * 4 + n * 4
    terms = 0 if mode == "pass" else kernel_size ** 2
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = max(2.0 * n * c * expanded / H100_BF16_TENSOR_FLOPS,
                n * expanded * max(2.0 * terms, 1.0) / H100_FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
