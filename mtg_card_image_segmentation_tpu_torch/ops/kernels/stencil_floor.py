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

On the card each mode is one launch of ``csrc/stencil_floor.cu`` (one CTA
per image; ``stencil_plan`` is its launch plan and lists the shapes it
takes); the plain version below runs for CPU tensors only.
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


# the kernel's tiling (csrc/stencil_floor.cu): expanded channels per slice,
# x pixels per staged chunk, threads per CTA, pixel pairs per chain strip,
# the widest input whose product weights fit in registers, the shared memory
# one CTA may take
SLICE, CHUNK, THREADS, STRIP_PAIRS, MAX_CIN = 64, 128, 512, 2, 160
MAX_SMEM = 232448


def _align(v: int) -> int:
    return (v + 127) // 128 * 128


def stencil_plan(shape, expanded: int, kernel_size: int = 5, dilation: int = 2) -> dict:
    """The kernel's launch plan for x of ``shape`` (B, H, W, C): one CTA of
    512 threads per image, the expanded channels in slices of 64, x in
    chunks of 128 pixels. ``smem_bytes`` is the CTA's shared memory, as the
    kernel lays it out: the image's y slice (which also holds the slice of
    ``w_exp`` at a slice's start), two x chunks (MAX_CIN channels a pixel,
    those past C zero), the slice's tap weights as bf16 pairs, one float
    per pixel.
    ``strip_rows`` lists the output rows of each chain strip (2 *
    STRIP_PAIRS rows of one residue class mod the dilation, rows past the
    image included); each strip runs over ``col_groups`` groups of 8
    columns. Raises ``ValueError`` for a shape the kernel does not take."""
    b, h, w, c = shape
    k, d = kernel_size, dilation
    if (w % 8 or c % 16 or c > MAX_CIN or expanded % SLICE or kernel_size not in (3, 5)
            or d < 1):
        raise ValueError(f"kernel wants W a multiple of 8, C a multiple of 16 up to {MAX_CIN}, "
                         f"E a multiple of {SLICE}, k 3 or 5 and dilation >= 1, got W={w} "
                         f"C={c} E={expanded} k={k} dilation={d}")
    npix = h * w
    smem = (_align(max(npix * SLICE * 2, SLICE * (c + 8) * 2))
            + _align(2 * CHUNK * MAX_CIN * 2) + _align(k * k * SLICE // 2 * 4)
            + _align(npix * 4))
    if smem > MAX_SMEM:
        raise ValueError(f"an image of {h}x{w} with C={c} needs {smem} bytes of shared "
                         f"memory per CTA, more than {MAX_SMEM}")
    per_res = -(-h // d)
    blocks = -(-per_res // (2 * STRIP_PAIRS))
    # strip blk * d + r, as the kernel numbers them
    strip_rows = [[r + d * (2 * STRIP_PAIRS * blk + j) for j in range(2 * STRIP_PAIRS)]
                  for blk in range(blocks) for r in range(d)]
    col_groups = -(-w // 8)
    return {"ctas": b, "threads": THREADS, "slice": SLICE, "slices": expanded // SLICE,
            "chunk_px": CHUNK, "chunks": -(-npix // CHUNK), "smem_bytes": smem,
            "ctas_per_sm": 1, "strips": len(strip_rows), "strip_rows": strip_rows,
            "col_groups": col_groups, "tasks": len(strip_rows) * col_groups}


def stencil_floor(x: torch.Tensor, w_exp: torch.Tensor, w_dw: torch.Tensor,
                  mode: str, kernel_size: int = 5, dilation: int = 2) -> torch.Tensor:
    """x (B, H, W, C) bfloat16, w_exp (C, E) float32, w_dw (k*k, E) float32
    -> (B, H, W, 1) float32. One kernel launch for a CUDA tensor (the shapes
    ``stencil_plan`` takes); a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return stencil_floor_plain(x, w_exp, w_dw, mode, kernel_size, dilation)
    _check(x, w_exp, w_dw, mode, kernel_size)
    stencil_plan(tuple(x.shape), w_exp.shape[1], kernel_size, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w_exp.device != x.device or w_dw.device != x.device:
        raise ValueError("x, w_exp and w_dw must lie on one device")
    b, h, w, c = x.shape
    e = w_exp.shape[1]
    x, w_exp, w_dw = x.contiguous(), w_exp.contiguous(), w_dw.contiguous()
    if any(t.data_ptr() % 16 for t in (x, w_exp, w_dw)):
        raise ValueError("kernel wants x, w_exp and w_dw at 16-byte aligned addresses")
    out = torch.empty((b, h, w, 1), dtype=torch.float32, device=x.device)
    fn = _build.bind("stencil_floor", "mtg_stencil_floor", _ARGS)
    err = fn(x.data_ptr(), w_exp.data_ptr(), w_dw.data_ptr(), out.data_ptr(),
             b, h, w, c, e, kernel_size, dilation, MODES.index(mode),
             _build.stream_ptr(x))
    _build.check(err, f"stencil_floor[{mode}]")
    _build.count("stencil_floor")
    return out


def kernel_smem_bytes(h: int, w: int, c: int, kernel_size: int) -> int:
    """The kernel's own count of one CTA's shared-memory bytes (needs the
    built library; the plan's ``smem_bytes`` must equal it)."""
    fn = _build.bind("stencil_floor", "mtg_stencil_floor_smem", [_I] * 4)
    return int(fn(h, w, c, kernel_size))


# published peaks of one H100 SXM: HBM3 bytes/s, dense bf16 tensor-core
# flop/s, float32 and packed bf16 flop/s outside the tensor cores (NVIDIA's
# data sheet and Hopper white paper)
H100_HBM_BYTES_PER_S, H100_BF16_TENSOR_FLOPS = 3.35e12, 989e12
H100_FP32_FLOPS, H100_BF16_FLOPS = 67e12, 134e12


def bound_ms(shape, expanded: int, mode: str, kernel_size: int = 5,
             packed_products: bool = True):
    """(ms, "bytes" | "operations"): the least time an H100 could take for
    one call. Bytes: x, both weights and the output once over the HBM rate.
    Operations: the expand product on the tensor cores, and on the CUDA
    cores per expanded value the k*k products of the term chain at the
    packed bf16 rate (``mul.rn.bf16x2`` rounds the exact product of two bf16
    values once, as the reference does) and k*k float32 adds (k*k - 1 in the
    chain, one into the channel sum; in ``pass`` the one add); the tensor
    cores and the CUDA cores run side by side. ``packed_products=False``
    counts the products at the float32 rate instead (the bound before the
    packed products)."""
    b, h, w, c = shape
    n = b * h * w
    nbytes = n * c * 2 + c * expanded * 4 + kernel_size ** 2 * expanded * 4 + n * 4
    terms = 0 if mode == "pass" else kernel_size ** 2
    product_rate = H100_BF16_FLOPS if packed_products else H100_FP32_FLOPS
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = max(2.0 * n * c * expanded / H100_BF16_TENSOR_FLOPS,
                n * expanded * (terms / product_rate + max(terms, 1) / H100_FP32_FLOPS))
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
