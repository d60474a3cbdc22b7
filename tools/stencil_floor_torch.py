#!/usr/bin/env python
"""Split the cost of the tail block's depthwise stencil on a CUDA card.

    python tools/stencil_floor_torch.py        (needs one CUDA card and nvcc)

The card's counterpart of ``tools/vpu_stencil_floor.py``: the same shapes
and seed (block 13 of the serving tail: 128 images of 32x32, 160 -> 960
channels, k=5, dilation 2), the same three variants, each one launch of the
hand-written kernel ``csrc/stencil_floor.cu``:

  full      the real stencil (shifted windows + the 25-term chain)
  arith     the same 25-term chain on UNSHIFTED operands (same operation
            count, no window movement; wrong math on purpose, timing only)
  pass      the expand product and the channel mean alone

``full - pass`` is the stencil's whole cost, ``arith - pass`` its arithmetic;
their ratio says how much of the stencil is window movement and how much is
the term chain itself. In the kernel (one CTA per image, the image's y
slice in shared memory, see the source's header) ``pass`` is x copied in
once per 64-channel slice, the expand product on wgmma and y written to and
read back from the shared tile; ``arith - pass`` is the 25-term chain: the
packed bf16 products (``mul.rn.bf16x2``) and their sums on the tensor cores
(``mma.sync`` against ones); ``full - arith`` is the window movement: the
shifted window values loaded from the tile, with the zero fill at the
image's edges. Times are CUDA events over back-to-back launches. Every
line carries the card's name and power limit. Exits non-zero without a
card. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.ops.kernels import stencil_floor as sf
from mtg_card_image_segmentation_tpu_torch.utils.platform import (
    nvidia_smi_name_power,
    resolve_device,
)

B, H, W, CIN, CEXP, K, DIL = 128, 32, 32, 160, 960, 5, 2


def make_inputs(seed: int = 0, device="cuda"):
    """(x, w_exp, w_dw) as the TPU tool's ``main`` draws them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, H, W, CIN)).astype(np.float32))
    w_exp = torch.from_numpy((rng.standard_normal((CIN, CEXP)) * 0.05).astype(np.float32))
    w_dw = torch.from_numpy((rng.standard_normal((K * K, CEXP)) * 0.05).astype(np.float32))
    return x.to(device, torch.bfloat16), w_exp.to(device), w_dw.to(device)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def run(iters: int = 20, seed: int = 0) -> dict:
    """Time the three modes on the card; returns {"ms": {mode: ms},
    "bound_ms": {mode: (ms, by)}, "checksum": {mode: float}, ...}."""
    device = resolve_device(None)
    x, w_exp, w_dw = make_inputs(seed, device)
    ms, bounds, sums = {}, {}, {}
    for mode in sf.MODES:
        out = sf.stencil_floor(x, w_exp, w_dw, mode, K, DIL)
        torch.cuda.synchronize()
        if tuple(out.shape) != (B, H, W, 1) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{mode}: bad output {tuple(out.shape)}")
        sums[mode] = float(out.double().sum())
        ms[mode] = cuda_ms(lambda: sf.stencil_floor(x, w_exp, w_dw, mode, K, DIL), iters)
        bounds[mode] = sf.bound_ms((B, H, W, CIN), CEXP, mode, K)
    n_terms = B * H * W * CEXP * K * K
    arith = ms["arith"] - ms["pass"]
    stencil = ms["full"] - ms["pass"]
    return {"ms": ms, "bound_ms": bounds, "checksum": sums, "terms": n_terms,
            "arith_minus_pass_ms": arith, "full_minus_pass_ms": stencil,
            "tera_terms_per_s": n_terms / (arith * 1e-3) / 1e12 if arith > 0 else None,
            "card": nvidia_smi_name_power()}


def main() -> int:
    if not torch.cuda.is_available():
        print("stencil_floor_torch: no CUDA card", file=sys.stderr)
        return 2
    r = run()
    card = r["card"]
    for mode in sf.MODES:
        b_ms, by = r["bound_ms"][mode]
        print(f"{mode:6s}: {r['ms'][mode]:.3f} ms   bound {b_ms:.3f} ms ({by})   [{card}]")
    rate = r["tera_terms_per_s"]
    print(f"pure stencil arithmetic (arith - pass): {r['arith_minus_pass_ms']:.3f} ms per "
          f"block-13 equivalent -> {rate:.2f} T terms/s (multiply + round + add per term)"
          f"   [{card}]" if rate else f"arith - pass = {r['arith_minus_pass_ms']:.3f} ms   [{card}]")
    print(f"stencil incl. window movement (full - pass): {r['full_minus_pass_ms']:.3f} ms"
          f"   [{card}]")
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
