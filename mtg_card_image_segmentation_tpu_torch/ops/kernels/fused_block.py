"""Fused MobileNetV3 inverted-residual block and the dilated tail chain
(counterpart of the JAX package's ``ops/pallas/fused_block.py``).

One folded block: [1x1 expand] -> k x k depthwise (any odd k, any
dilation, stride 1 or 2 = the even rows/cols of the full stencil) -> [SE]
-> 1x1 project [+ residual]. On the card it runs as four CUDA kernels
(``csrc/fused_block.cu``, design (b): the expanded and depthwise maps go
through device memory in bf16):

- K1 ``expand_gemm`` and K4 ``project_gemm``: one persistent TMA + ``wgmma``
  GEMM. A producer warp feeds a ring of 128x64 A tiles (and BNx64 B tiles)
  on mbarriers; two consumer warpgroups multiply with A in registers, where
  K4 multiplies in the SE gate. The expand keeps its B panel resident and
  writes its bf16 output by TMA stores. :func:`gemm_plan` picks the tiles,
  the ring's depth and whether B stays resident.
- K2 ``depthwise``: the window of a band of rows in shared memory (by
  cp.async), each bf16 product made two channels at a time (``__hmul2``)
  and summed in fp32, two output pixels per thread; it also writes the SE
  sums.
- K3 ``se_gate``.

``fused_tail_chain`` runs blocks 12-14 through the same kernels and keeps
the values between blocks in float32, as the TPU chain does in VMEM; each
K4 but the last also writes the bf16 rounding of its output, which the
next block's K1 reads as A (the float32 value stays its residual).

The plain versions (``*_plain``) repeat the TPU kernel's precision: bf16
inputs to the products with fp32 accumulation, each depthwise term rounded
to bf16 and summed in fp32 (columns outer, rows inner), SE in fp32 with its
gate rounded to bf16. The wrappers take them only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
from mtg_card_image_segmentation_tpu_torch.utils.profiling import Span

_P, _I = ctypes.c_void_p, ctypes.c_int
_GEMM_ARGS = [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P] + [_I] * 9 + [_P]
_DW_ARGS = [_P] * 5 + [_I] * 11 + [_P]
_SE_ARGS = [_P, _I, _I] + [_P] * 5 + [_I] * 3 + [_P]
_SMEM_ARGS = [_I] * 5
_ACT = {None: 0, "relu": 1, "hardswish": 2}
# shared bytes per depthwise CTA (its window and tap weights): three CTAs per
# SM; a 32x32 map with k = 5 at dilation 2 fits as one band
_DW_SMEM_BUDGET = 64 * 1024
BF16 = torch.bfloat16
GEMM_BM, GEMM_BK = 128, 64
GEMM_BN = (80, 160, 240)  # output-tile widths, multiples of the wgmma N of 80
SMEM_LIMIT = 227 * 1024  # shared memory one CTA may use
_BLOCK = Span("kernel.fused_inverted_residual", "kernels")
_CHAIN = Span("kernel.fused_tail_chain", "kernels")

# launch-counter names of the four kernels one block launches
BLOCK_KERNELS = ("expand_gemm", "depthwise", "se_gate", "project_gemm")


@dataclass(frozen=True)
class BlockWeights:
    """One folded block's weights in the kernels' layouts. GEMM weights are
    (out, in) bf16, depthwise taps (k*k, C) bf16, SE weights (in, out)
    fp32, biases fp32. The expanded width C is a multiple of 8 (see
    :meth:`from_flax`)."""

    kernel_size: int
    dw_w: torch.Tensor
    dw_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    exp_w: Optional[torch.Tensor] = None
    exp_b: Optional[torch.Tensor] = None
    se1_w: Optional[torch.Tensor] = None
    se1_b: Optional[torch.Tensor] = None
    se2_w: Optional[torch.Tensor] = None
    se2_b: Optional[torch.Tensor] = None

    @property
    def cexp(self) -> int:
        return self.dw_w.shape[1]

    @property
    def cin(self) -> int:
        return self.cexp if self.exp_w is None else self.exp_w.shape[1]

    @property
    def cout(self) -> int:
        return self.proj_w.shape[0]

    @classmethod
    def from_flax(cls, params: Mapping[str, Any], kernel_size: int,
                  device: Union[str, torch.device] = "cpu") -> "BlockWeights":
        """From a folded Flax block subtree ({"expand"?, "depthwise",
        "se"?, "project"}, HWIO kernels; numpy or torch leaves).

        The kernels move 8 channels (16 bytes) at a time, so an expanded
        width that is not a multiple of 8 (a slimmed block: 471 of 672) is
        widened here to the next multiple with zero channels: zero expand
        rows and biases, zero depthwise taps and biases, zero SE fc1 rows,
        fc2 columns and fc2 biases, zero project columns. Such a channel is
        act(0) = 0 after the expand and after the depthwise, adds 0 to the
        SE mean and 0 to the project, so the block's output is unchanged.
        ``cexp`` is the widened width."""

        def t(a, dtype):
            a = a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a, np.float32))
            return a.detach().to(device=device).float().to(dtype).contiguous()

        def mat(kernel, dtype):  # HWIO 1x1 -> (in, out)
            return t(kernel, torch.float32).reshape(-1, kernel.shape[-1]).to(dtype)

        cexp = params["depthwise"]["conv"]["kernel"].shape[-1]
        pad = -cexp % 8
        if pad and "expand" not in params:
            raise ValueError(f"a block without an expand conv needs a width that is a "
                             f"multiple of 8, got {cexp}")

        def widen(a, dim):  # zero channels up to the next multiple of 8
            if not pad:
                return a
            shape = list(a.shape)
            shape[dim] = pad
            return torch.cat([a, a.new_zeros(shape)], dim=dim).contiguous()

        kw = {}
        if "expand" in params:
            kw["exp_w"] = widen(mat(params["expand"]["conv"]["kernel"], BF16).t().contiguous(), 0)
            kw["exp_b"] = widen(t(params["expand"]["conv"]["bias"], torch.float32), 0)
        if "se" in params:
            kw["se1_w"] = widen(mat(params["se"]["fc1"]["kernel"], torch.float32), 0)
            kw["se1_b"] = t(params["se"]["fc1"]["bias"], torch.float32)
            kw["se2_w"] = widen(mat(params["se"]["fc2"]["kernel"], torch.float32), 1)
            kw["se2_b"] = widen(t(params["se"]["fc2"]["bias"], torch.float32), 0)
        dw = t(params["depthwise"]["conv"]["kernel"], torch.float32)
        return cls(
            kernel_size=kernel_size,
            dw_w=widen(dw.reshape(kernel_size * kernel_size, cexp).to(BF16), 1),
            dw_b=widen(t(params["depthwise"]["conv"]["bias"], torch.float32), 0),
            proj_w=widen(mat(params["project"]["conv"]["kernel"], BF16).t().contiguous(), 1),
            proj_b=t(params["project"]["conv"]["bias"], torch.float32),
            **kw,
        )

    @classmethod
    def from_module(cls, block) -> "BlockWeights":
        """From the port's folded ``InvertedResidual`` module."""

        def conv(m):
            return {"kernel": m.conv.weight.permute(2, 3, 1, 0), "bias": m.conv.bias}

        def lin(m):
            return {"kernel": m.weight.permute(2, 3, 1, 0), "bias": m.bias}

        tree = {"depthwise": {"conv": conv(block.depthwise)},
                "project": {"conv": conv(block.project)}}
        if block.expand is not None:
            tree["expand"] = {"conv": conv(block.expand)}
        if block.se is not None:
            tree["se"] = {"fc1": lin(block.se.fc1), "fc2": lin(block.se.fc2)}
        return cls.from_flax(tree, block.kernel, block.depthwise.conv.weight.device)


def kernel_takes(block) -> bool:
    """Whether the block kernels take the port's folded ``InvertedResidual``:
    a block without an expand conv needs a width that is a multiple of 8
    (:meth:`BlockWeights.from_flax` raises for it; an expand conv lets the
    width be widened with zero channels)."""
    return block.expand is not None or block.depthwise.conv.weight.shape[0] % 8 == 0


def _weights(params, kernel_size: int, device) -> BlockWeights:
    if isinstance(params, BlockWeights):
        return params
    return BlockWeights.from_flax(params, kernel_size, device)


def _act(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "hardswish":
        return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0
    return x


def _out_size(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def inverted_residual_plain(x: torch.Tensor, bw: BlockWeights, stride: int,
                            act: str, residual: bool, dilation: int,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """One block in plain PyTorch ops, at the TPU kernel's precision."""
    _, h, w, _ = x.shape
    k = bw.kernel_size
    if bw.exp_w is not None:
        y = x.to(BF16).float() @ bw.exp_w.float().t()
        y = _act(y + bw.exp_b, act).to(BF16)
    else:
        y = x.to(BF16)
    pad = (k - 1) // 2 * dilation
    yp = F.pad(y, (0, 0, pad, pad, pad, pad))
    oh, ow = _out_size(h, stride), _out_size(w, stride)
    acc = None
    for kx in range(k):
        for ky in range(k):
            oy, ox = ky * dilation, kx * dilation
            tap = yp[:, oy:oy + (oh - 1) * stride + 1:stride,
                     ox:ox + (ow - 1) * stride + 1:stride, :]
            term = (tap * bw.dw_w[ky * k + kx]).float()  # bf16-rounded product
            acc = term if acc is None else acc + term
    y = _act(acc + bw.dw_b, act).to(BF16)
    if bw.se1_w is not None:
        s = y.float().mean(dim=(1, 2))
        s = torch.relu(s @ bw.se1_w + bw.se1_b)
        s = s @ bw.se2_w + bw.se2_b
        s = torch.clamp(s + 3.0, 0.0, 6.0) / 6.0
        y = y * s.to(BF16)[:, None, None, :]
    out = y.float() @ bw.proj_w.float().t() + bw.proj_b
    if residual:
        out = out + x.float()
    return out.to(out_dtype)


def tail_chain_plain(x: torch.Tensor, blocks: Sequence[BlockWeights], act: str,
                     dilation: int) -> torch.Tensor:
    """Stride-1 blocks in sequence, float32 between blocks, residual where
    the block's input and output widths agree; the result in ``x.dtype``."""
    val = x
    for bw in blocks:
        val = inverted_residual_plain(val, bw, 1, act, bw.cin == bw.cout,
                                      dilation, torch.float32)
    return val.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gemm_smem(bn: int, stages: int, resident: bool, k_tiles: int) -> int:
    """Shared bytes of one GEMM CTA, in the order ``pw_gemm_kernel`` lays
    them out: 1024 bytes of alignment slack, the ring (A and B tiles, or A
    tiles and the resident B panel), two 64x88 fp32 epilogue staging tiles
    (one per warpgroup; the TMA-store epilogue uses their room), barriers.
    The launch takes this figure; the kernel traps if its layout needs
    more."""
    tile = GEMM_BK * 2
    ring = (stages * GEMM_BM * tile + k_tiles * bn * tile if resident
            else stages * (GEMM_BM + bn) * tile)
    return 1024 + ring + 2 * 64 * 88 * 4 + (2 * stages + 1) * 8


@functools.lru_cache(maxsize=256)
def gemm_plan(m: int, n: int, k: int, gated: bool, sm_count: int) -> dict:
    """The GEMM's launch plan for out[m, n] = A[m, k] @ Bt[n, k]^T.

    - N: the fewest tiles of at most 240 columns that cover ``n``, each the
      smallest width of ``GEMM_BN`` that covers its share (the project's 160
      is one tile, so A is read once; 672 and 960 take 3 and 4 tiles of 240,
      472 two).
    - M: 128-row tiles. K: 64-deep k tiles, the tail zero-filled by TMA
      (wgmma's depth is 16: ``k_pad16``).
    - B resident: without a gate, when the n tile's whole B panel and a ring
      of at least 4 A tiles fit in shared memory (the expand GEMMs), each
      CTA loads its panel once and streams A; the grid is then a multiple of
      the n tiles. Otherwise A and B tiles stream through the ring.
    - stages: the deepest ring (up to 8 resident, 6 streaming) that fits in
      227 KB (5 for the project and for the 160 -> 960 expand); the grid:
      one persistent CTA per SM at most (``sm_count``, the card's
      multiprocessor count)."""
    n_tiles = -(-n // GEMM_BN[-1])
    bn = next(b for b in GEMM_BN if b * n_tiles >= n)
    m_tiles = -(-m // GEMM_BM)
    k_tiles = -(-k // GEMM_BK)

    def deepest(resident, most):
        fits = [s for s in range(2, most + 1)
                if gemm_smem(bn, s, resident, k_tiles) <= SMEM_LIMIT]
        return fits[-1] if fits else 0

    resident = not gated and deepest(True, 8) >= 4
    stages = deepest(resident, 8 if resident else 6)
    grid = min(n_tiles * m_tiles, sm_count)
    if resident:
        grid = min(n_tiles * m_tiles, sm_count // n_tiles * n_tiles)
    return {"bm": GEMM_BM, "bn": bn, "bk": GEMM_BK, "stages": stages,
            "resident": resident, "n_tiles": n_tiles, "m_tiles": m_tiles,
            "k_tiles": k_tiles, "k_pad16": -(-k // 16) * 16, "k_loaded": k_tiles * GEMM_BK,
            "smem_bytes": gemm_smem(bn, stages, resident, k_tiles), "grid": grid}


def _gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
          gate: Optional[torch.Tensor], rows_per_image: int,
          res: Optional[torch.Tensor], out: torch.Tensor, act: Optional[str],
          name: str, out_copy: Optional[torch.Tensor] = None) -> None:
    n, k = w.shape
    m = a.numel() // k
    if m >= 2 ** 31 - GEMM_BM:  # the kernel's row coordinates are 32-bit
        raise ValueError(f"GEMM of {m} rows: at most 2^31 - {GEMM_BM}")
    if a.dtype != BF16 or w.dtype != BF16:
        raise ValueError(f"GEMM wants bf16 A and weights, got {a.dtype} and {w.dtype}")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("GEMM operands must be 16-byte aligned")
    plan = gemm_plan(m, n, k, gate is not None, _build.sm_count(a.device))
    fn = _build.bind("fused_block", "mtg_pw_gemm", _GEMM_ARGS)
    err = fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(gate), rows_per_image,
             _ptr(res), int(res is not None and res.dtype == torch.float32),
             out.data_ptr(), int(out.dtype == torch.float32), _ptr(out_copy), m, n, k,
             _ACT[act], plan["bn"], plan["stages"], int(plan["resident"]), plan["grid"],
             plan["smem_bytes"], _build.stream_ptr(a))
    _build.check(err, name)
    _build.count(name)


def pw_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  gate: Optional[torch.Tensor] = None, rows_per_image: int = 0,
                  res: Optional[torch.Tensor] = None, act: Optional[str] = None,
                  out_dtype: torch.dtype = BF16) -> torch.Tensor:
    """``act(bf16(A x gate) @ w^T + bias) (+ res)`` at the kernels'
    precision: A (M, K) bf16, w (N, K) bf16, gate (images, K) bf16 per
    ``rows_per_image`` rows, multiplied into A with a bf16 rounding."""
    a = a.reshape(-1, w.shape[1]).to(BF16)
    if gate is not None:
        a = (a.reshape(-1, rows_per_image, a.shape[1]) * gate[:, None, :]).reshape(a.shape)
    y = _act(a.float() @ w.float().t() + bias, act)
    if res is not None:
        y = y + res.reshape(y.shape).float()
    return y.to(out_dtype)


def pw_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            gate: Optional[torch.Tensor] = None, rows_per_image: int = 0,
            res: Optional[torch.Tensor] = None, act: Optional[str] = None,
            out_dtype: torch.dtype = BF16, name: str = "project_gemm") -> torch.Tensor:
    """K1/K4 on their own (``pw_gemm_plain``'s function, (M, N) out): the
    kernel for CUDA tensors, counted under ``name``; the plain version for
    CPU tensors."""
    if a.device.type == "cpu":
        return pw_gemm_plain(a, w, bias, gate, rows_per_image, res, act, out_dtype)
    if a.device.type != "cuda" or not a.is_contiguous():
        raise ValueError(f"kernel path wants a contiguous CUDA tensor, got {a.device}")
    out = torch.empty((a.numel() // w.shape[1], w.shape[0]), dtype=out_dtype, device=a.device)
    _gemm(a, w, bias, gate, rows_per_image, res, out, act, name)
    return out


def _band_rows(oh: int, w: int, k: int, stride: int, dilation: int) -> int:
    """Most output rows per depthwise CTA whose padded input band fits the
    shared-memory budget."""
    smem = _build.bind("fused_block", "mtg_depthwise_smem", _SMEM_ARGS)
    rows = oh
    while rows > 1 and smem(rows, w, k, stride, dilation) > _DW_SMEM_BUDGET:
        rows = (rows + 1) // 2
    return rows


def _check_input(x: torch.Tensor, bw: BlockWeights) -> None:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"want a contiguous NHWC tensor, got {tuple(x.shape)}")
    if x.shape[-1] != bw.cin:
        raise ValueError(f"input has {x.shape[-1]} channels, block wants {bw.cin}")
    if bw.dw_w.device != x.device:
        raise ValueError(f"weights on {bw.dw_w.device}, input on {x.device}")
    if x.shape[1] * x.shape[2] <= 0 or x.shape[0] > 65535:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")


def _depthwise(y: torch.Tensor, bw: BlockWeights, stride: int, act: str,
               dilation: int):
    """K2: (depthwise map, SE sums or None, bands). Any odd kernel size:
    3 and 5 (the model's) have unrolled tap loops, others a loop over k."""
    b, h, w, cexp = y.shape
    k = bw.kernel_size
    if k < 1 or k % 2 == 0:
        raise ValueError(f"the depthwise kernel takes an odd kernel size, got {k}")
    oh, ow = _out_size(h, stride), _out_size(w, stride)
    band = _band_rows(oh, w, k, stride, dilation)
    nbands = -(-oh // band)
    dw = torch.empty((b, oh, ow, cexp), dtype=BF16, device=y.device)
    sums = (torch.empty((b, nbands, cexp), dtype=torch.float32, device=y.device)
            if bw.se1_w is not None else None)
    fn = _build.bind("fused_block", "mtg_depthwise", _DW_ARGS)
    err = fn(y.data_ptr(), bw.dw_w.data_ptr(), bw.dw_b.data_ptr(), dw.data_ptr(),
             _ptr(sums), b, h, w, cexp, oh, ow, k, stride, dilation, band,
             _ACT[act], _build.stream_ptr(y))
    _build.check(err, "depthwise")
    _build.count("depthwise")
    return dw, sums, nbands


def _se_gate(sums: torch.Tensor, nbands: int, npix: int, bw: BlockWeights) -> torch.Tensor:
    """K3: the (B, C) bf16 gate from the SE sums."""
    b, _, cexp = sums.shape
    gate = torch.empty((b, cexp), dtype=BF16, device=sums.device)
    fn = _build.bind("fused_block", "mtg_se_gate", _SE_ARGS)
    err = fn(sums.data_ptr(), nbands, npix, bw.se1_w.data_ptr(),
             bw.se1_b.data_ptr(), bw.se2_w.data_ptr(), bw.se2_b.data_ptr(),
             gate.data_ptr(), b, cexp, bw.se1_w.shape[1], _build.stream_ptr(sums))
    _build.check(err, "se_gate")
    _build.count("se_gate")
    return gate


def inverted_residual_kernels(x: torch.Tensor, bw: BlockWeights, stride: int,
                              act: str, residual: bool, dilation: int,
                              out_dtype: torch.dtype,
                              x_bf16: Optional[torch.Tensor] = None,
                              bf16_copy: bool = False):
    """One block as the four CUDA kernels. ``x`` is bf16, or float32 (the
    chain's value between blocks, used as the residual) with ``x_bf16`` its
    bf16 rounding, which K1 reads. The output is ``out_dtype``; with
    ``bf16_copy`` K4 also writes its bf16 rounding and both are returned."""
    _check_input(x, bw)
    a = x if x.dtype == BF16 else x_bf16
    if a is None or a.dtype != BF16 or a.shape != x.shape:
        raise ValueError(f"K1 reads bf16: a {x.dtype} input needs its bf16 rounding")
    b, h, w, _ = x.shape
    dev = x.device
    if bw.exp_w is not None:
        y = torch.empty((b, h, w, bw.cexp), dtype=BF16, device=dev)
        _gemm(a, bw.exp_w, bw.exp_b, None, 0, None, y, act, "expand_gemm")
    else:
        y = a
    dw, sums, nbands = _depthwise(y, bw, stride, act, dilation)
    _, oh, ow, _ = dw.shape
    gate = _se_gate(sums, nbands, oh * ow, bw) if sums is not None else None
    out = torch.empty((b, oh, ow, bw.cout), dtype=out_dtype, device=dev)
    copy = torch.empty(out.shape, dtype=BF16, device=dev) if bf16_copy else None
    _gemm(dw, bw.proj_w, bw.proj_b, gate, oh * ow, x if residual else None,
          out, None, "project_gemm", copy)
    return (out, copy) if bf16_copy else out


# ---------------------------------------------------------------------------
# public wrappers (the JAX package's signatures)
# ---------------------------------------------------------------------------


def fused_inverted_residual(x: torch.Tensor, params, kernel_size: int = 3,
                            stride: int = 1, act: str = "relu",
                            residual: bool = False,
                            dilation: int = 1) -> torch.Tensor:
    """Run one folded inverted-residual block. ``params`` is a folded Flax
    block subtree or a :class:`BlockWeights`. The residual applies when
    asked for, stride is 1 and cin == cout. A CUDA tensor (bf16) goes
    through the kernels; a CPU tensor takes the plain version."""
    bw = _weights(params, kernel_size, x.device)
    use_residual = residual and stride == 1 and bw.cin == bw.cout
    if x.device.type == "cpu":
        return inverted_residual_plain(x, bw, stride, act, use_residual,
                                       dilation, x.dtype)
    with _BLOCK:
        if x.device.type != "cuda" or x.dtype != BF16:
            raise ValueError(f"kernel path wants a bf16 CUDA tensor, got {x.dtype} on {x.device}")
        return inverted_residual_kernels(x, bw, stride, act, use_residual,
                                         dilation, BF16)


def fused_tail_chain(x: torch.Tensor, params_list: Sequence, kernel_size: int = 5,
                     act: str = "hardswish", dilation: int = 2) -> torch.Tensor:
    """A chain of stride-1 blocks (the serving tail, blocks 12-14), float32
    between blocks, residual where cin == cout. Widths come from the
    params. A CUDA tensor (bf16) goes through the kernels, whose launches
    count under ``BLOCK_KERNELS``; a CPU tensor takes the plain version."""
    blocks = [_weights(p, kernel_size, x.device) for p in params_list]
    if x.device.type == "cpu":
        return tail_chain_plain(x, blocks, act, dilation)
    with _CHAIN:
        if x.device.type != "cuda" or x.dtype != BF16:
            raise ValueError(f"kernel path wants a bf16 CUDA tensor, got {x.dtype} on {x.device}")
        val, val_bf16 = x, x
        for i, bw in enumerate(blocks):
            last = i == len(blocks) - 1
            res = inverted_residual_kernels(
                val, bw, 1, act, bw.cin == bw.cout, dilation,
                BF16 if last else torch.float32, x_bf16=val_bf16, bf16_copy=not last,
            )
            val, val_bf16 = (res, res) if last else res
        return val
