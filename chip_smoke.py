#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py        (from the root of a checkout; needs one card)

Builds the hand-written kernels from ``mtg_card_image_segmentation_tpu_torch/
csrc/`` (into ``build/kernels/``), holds each kernel against its plain
PyTorch version on the card at the main path's shapes, then drives the main
path, ``SegPredictor.predict`` at 512x512 with the full-width MobileNetV3-
Large + LR-ASPP (random weights from a seed), and checks its masks against
the port's own CPU predictor and against its stock-op reference path.
Last it profiles a few b128 ``predict`` calls: device time by kernel class
and the card's idle share.

Every phase prints one JSON line. Then come the kernels' summary line, the
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` line, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that last line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "mtg_card_image_segmentation_tpu_torch"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12  # dense bf16 on the tensor cores
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
TOL = 0.06                  # max|d| gate, tests/test_pallas_fused_block.py:156
SIZE = 512
BATCHES = (32, 128)
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events after ``warmup`` calls."""
    import torch

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


def bound(nbytes: float, tensor_flops: float = 0.0, fp32_flops: float = 0.0):
    """Least time (ms) for the work: the larger of bytes over the HBM rate
    and the operations over their unit's peak (tensor cores and CUDA cores
    run side by side, so the slower of the two)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(tensor_flops / BF16_TENSOR_FLOPS, fp32_flops / FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_env(torch):
    from mtg_card_image_segmentation_tpu_torch.ops.kernels._build import _nvcc
    from mtg_card_image_segmentation_tpu_torch.utils.platform import describe_card

    nvcc = subprocess.run([_nvcc(), "--version"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()
    card = describe_card(0)
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": [l for l in nvcc if "release" in l][0],
          **card})
    return card


def phase_build():
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    seconds = time.perf_counter() - t0
    kernels = []
    for src, rec in info.items():
        for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes stack frame, (\d+) "
            r"bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) registers([^\n]*)",
            rec["ptxas"], re.S):
            name = re.search(r"\d+([a-z_]+_kernel)(I.*?E)?E", m.group(1))
            smem = re.search(r"(\d+) bytes smem", m.group(6))
            kernels.append({"source": f"csrc/{src}.cu",
                            "fn": "".join(g or "" for g in name.groups()) if name else m.group(1),
                            "registers": int(m.group(5)),
                            "static_smem": int(smem.group(1)) if smem else 0,
                            "spill_stores": int(m.group(3)),
                            "spill_loads": int(m.group(4))})
    if not kernels:
        fail("no ptxas report from the build")
    emit({"phase": "build", "seconds": round(seconds, 3),
          "per_source_seconds": {k: round(v["seconds"], 3) for k, v in info.items()},
          "kernels": kernels})


def phase_kernels(torch, weights):
    """Each kernel against its plain version on the card, at the main
    path's shapes; times from CUDA events."""
    import numpy as np
    import torch.nn.functional as F

    from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import decoder as dec
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import fused_block as fb
    from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows = {}

    # -- fused_mask_decode: (128, 64, 64) f32 -> 512x512 u8, bit-exact ------
    b, h = BATCHES[-1], SIZE // 8
    s = torch.from_numpy(rng.standard_normal((b, h, h)).astype(np.float32)).to(dev)
    got = dec.fused_mask_decode(s, SIZE, SIZE)
    want = dec.fused_mask_decode_plain(s, SIZE, SIZE)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    err = float((got.float() - want.float()).abs().max())
    if mismatches:
        fail(f"fused_mask_decode differs from its plain version on {mismatches} pixels")
    lib = lambda: F.interpolate(s[:, None], size=(SIZE, SIZE), mode="bilinear",
                                align_corners=False)[:, 0] > 0
    lib_agree = float((lib().to(torch.uint8) == got).float().mean())
    bnd, by = bound(b * h * h * 4 + b * SIZE * SIZE,
                    fp32_flops=3 * b * SIZE * (h + SIZE))
    rows["fused_mask_decode"] = {
        "ms": cuda_ms(lambda: dec.fused_mask_decode(s, SIZE, SIZE), 50),
        "plain_ms": cuda_ms(lambda: dec.fused_mask_decode_plain(s, SIZE, SIZE), 10),
        "library_ms": cuda_ms(lib, 50), "bound_ms": bnd, "bound_by": by,
        "max_abs_err": err}
    emit({"phase": "kernel", "name": "fused_mask_decode", "shape": [b, h, h],
          "out": [b, SIZE, SIZE], "exact": True, "agreement_with_library": lib_agree,
          **rows["fused_mask_decode"]})

    # -- fused_inverted_residual: the six test shapes + the dilated tail ----
    folded = fold_batch_norm(*weights)
    bb = folded["backbone"]
    model = from_flax(folded, None, dtype=torch.bfloat16).to(dev, torch.bfloat16)
    model = model.to(memory_format=torch.channels_last)

    def block_case(i, n, hw):
        blk = model.backbone.block(i)
        bw = fb.BlockWeights.from_flax(bb[f"block{i}"], blk.kernel, dev)
        x = torch.from_numpy(rng.standard_normal((n, hw, hw, blk.in_features))
                             .astype(np.float32)).to(dev, torch.bfloat16)
        args = (bw, blk.kernel, blk.stride, blk.act, blk.residual, blk.dilation)
        return blk, bw, x, args

    for i in (0, 1, 2, 3, 4, 8, 13):  # tests/test_pallas_fused_block.py:38-48 + tail
        blk, bw, x, (bw, k, st, act, res, dil) = block_case(i, 8, 16)
        got = fb.fused_inverted_residual(x, bw, k, st, act, res, dil)
        want = fb.inverted_residual_plain(x, bw, st, act, res, dil, torch.bfloat16)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        ok = float(d.max()) <= TOL
        emit({"phase": "kernel", "name": "fused_inverted_residual", "block": i,
              "shape": list(x.shape), "k": k, "stride": st, "dilation": dil,
              "se": bw.se1_w is not None, "act": act, "residual": res,
              "max_abs_err": float(d.max()), "max_abs_ref": float(want.float().abs().max()),
              "within_tol": ok})
        if not ok:
            fail(f"fused_inverted_residual block{i}: max|d| {float(d.max())} > {TOL}")

    # main-path shape of one tail block (block13, b128 at 32x32), timed
    blk, bw, x, (bw, k, st, act, res, dil) = block_case(13, b, SIZE // 16)
    got = fb.fused_inverted_residual(x, bw, k, st, act, res, dil)
    want = fb.inverted_residual_plain(x, bw, st, act, res, dil, torch.bfloat16)
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    if float(d.max()) > TOL:
        fail(f"fused_inverted_residual block13 at b128: max|d| {float(d.max())} > {TOL}")
    m = x.shape[0] * x.shape[1] * x.shape[2]
    se_ops = 4 * b * bw.cexp * bw.se1_w.shape[1]
    wbytes = sum(t.numel() * t.element_size() for t in
                 (bw.exp_w, bw.exp_b, bw.dw_w, bw.dw_b, bw.se1_w, bw.se1_b,
                  bw.se2_w, bw.se2_b, bw.proj_w, bw.proj_b))
    bnd, by = bound(m * (bw.cin + bw.cout) * 2 + wbytes,
                    tensor_flops=2 * m * bw.cexp * (bw.cin + bw.cout),
                    fp32_flops=2 * m * k * k * bw.cexp + se_ops)
    xc = x
    rows["fused_inverted_residual"] = {
        "ms": cuda_ms(lambda: fb.fused_inverted_residual(xc, bw, k, st, act, res, dil), 20),
        "plain_ms": cuda_ms(lambda: fb.inverted_residual_plain(xc, bw, st, act, res, dil,
                                                               torch.bfloat16), 3),
        "library_ms": cuda_ms(lambda: blk(xc), 20), "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float(d.max())}
    emit({"phase": "kernel", "name": "fused_inverted_residual", "block": 13,
          "shape": list(x.shape), "timed": True, "max_abs_ref": float(want.float().abs().max()),
          **rows["fused_inverted_residual"]})

    # -- fused_tail_chain at full widths (128, 32, 32, 112) ------------------
    blocks = [fb.BlockWeights.from_flax(bb[f"block{i}"], 5, dev) for i in (12, 13, 14)]
    mods = [model.backbone.block(i) for i in (12, 13, 14)]
    x = torch.from_numpy(rng.standard_normal((b, SIZE // 16, SIZE // 16, 112))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    got = fb.fused_tail_chain(x, blocks, 5, "hardswish", 2)
    want = fb.tail_chain_plain(x, blocks, "hardswish", 2)
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    if float(d.max()) > TOL:
        fail(f"fused_tail_chain: max|d| {float(d.max())} > {TOL}")

    def library_chain():
        y = x
        for mod in mods:
            y = mod(y)
        return y

    lib_err = float((library_chain().float() - want.float()).abs().max())
    m = x.shape[0] * x.shape[1] * x.shape[2]
    tflops = sum(2 * m * bw.cexp * (bw.cin + bw.cout) for bw in blocks)
    fflops = sum(2 * m * 25 * bw.cexp + 4 * b * bw.cexp * bw.se1_w.shape[1] for bw in blocks)
    wbytes = sum(t.numel() * t.element_size() for bw in blocks for t in
                 (bw.exp_w, bw.exp_b, bw.dw_w, bw.dw_b, bw.se1_w, bw.se1_b,
                  bw.se2_w, bw.se2_b, bw.proj_w, bw.proj_b))
    bnd, by = bound(m * (112 + 160) * 2 + wbytes, tensor_flops=tflops, fp32_flops=fflops)
    rows["fused_tail_chain"] = {
        "ms": cuda_ms(lambda: fb.fused_tail_chain(x, blocks, 5, "hardswish", 2), 20),
        "plain_ms": cuda_ms(lambda: fb.tail_chain_plain(x, blocks, "hardswish", 2), 3),
        "library_ms": cuda_ms(library_chain, 20), "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float(d.max())}
    emit({"phase": "kernel", "name": "fused_tail_chain", "shape": list(x.shape),
          "gflop_tensor": tflops / 1e9, "gflop_fp32": fflops / 1e9,
          "max_abs_ref": float(want.float().abs().max()),
          "library_max_abs_err": lib_err, **rows["fused_tail_chain"]})
    return rows


def phase_end_to_end(torch, weights, card):
    """SegPredictor.predict at 512x512 through the kernels, with the
    launch counts of the run, against the CPU plain path and the stock-op
    reference path."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import BLOCK_KERNELS
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

    params, stats = weights
    pred = SegPredictor(params, stats, SIZE, SIZE)
    ref = SegPredictor(params, stats, SIZE, SIZE, use_kernels=False)
    # the tail chain has no kernel of its own: it shows as the K1-K4
    # launches (BLOCK_KERNELS) of its three blocks
    needed = ("fused_mask_decode",) + BLOCK_KERNELS
    launches = {}
    for b in BATCHES:
        imgs = np.random.default_rng(SEED + b).integers(0, 256, (b, SIZE, SIZE, 3), np.uint8)
        dev_imgs = torch.from_numpy(imgs).cuda()
        pred.predict(dev_imgs)  # first call: weights, cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls = 5
        _build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(calls):
            masks = pred.predict(dev_imgs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / calls
        counts = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        missing = [n for n in needed if counts.get(n, 0) <= 0]
        if missing:
            fail(f"main path at b{b} launched no {missing}: {counts}")
        if masks.dtype != torch.uint8 or tuple(masks.shape) != (b, SIZE, SIZE):
            fail(f"masks {masks.dtype} {tuple(masks.shape)}")
        if int(masks.max()) > 1:
            fail("masks hold values other than 0 and 1")
        ref_masks = ref.predict(dev_imgs)
        agree_ref = float((ref_masks == masks).float().mean())
        t0 = time.perf_counter()
        for _ in range(calls):
            ref.predict(dev_imgs)
        torch.cuda.synchronize()
        ref_ms = (time.perf_counter() - t0) * 1e3 / calls
        if agree_ref < 0.99:
            fail(f"b{b}: agreement with use_kernels=False {agree_ref} < 0.99")
        launches[b] = counts
        emit({"phase": "end_to_end", "batch": b, "size": SIZE, "calls": calls,
              "ms_per_batch": ms, "img_per_s": b * 1e3 / ms,
              "reference_path_ms_per_batch": ref_ms,
              "peak_mem_bytes": peak, "launches": counts,
              "foreground_fraction": float(masks.float().mean()),
              "agreement_vs_use_kernels_false": agree_ref,
              "card": card["name"], "nvidia_smi": card["nvidia_smi"]})

    # the card's kernel path against the port's CPU path (plain versions),
    # same weights, same bf16 dtype, first 4 images of the b128 batch
    imgs = np.random.default_rng(SEED + BATCHES[-1]).integers(
        0, 256, (4, SIZE, SIZE, 3), np.uint8)
    cpu = SegPredictor(params, stats, SIZE, SIZE, device="cpu")
    t0 = time.perf_counter()
    agree_cpu = pred.mask_agreement(cpu, imgs)
    emit({"phase": "card_vs_cpu", "images": 4, "size": SIZE,
          "agreement": agree_cpu, "seconds": time.perf_counter() - t0})
    if agree_cpu < 0.999:
        fail(f"card kernel path vs CPU plain path agreement {agree_cpu} < 0.999")
    return launches[BATCHES[-1]], pred, dev_imgs


# profiled kernel-name fragments -> class, first match wins
PROFILE_CLASSES = (
    ("tail chain: expand/project GEMM (pw_gemm_kernel)", ("pw_gemm_kernel",)),
    ("tail chain: depthwise + SE sums (depthwise_kernel)", ("depthwise_kernel",)),
    ("tail chain: SE gate (se_gate_kernel)", ("se_gate_kernel",)),
    ("mask decode (mask_decode_kernel)", ("mask_decode_kernel",)),
    ("cuDNN convolutions", ("conv", "xmma", "implicit", "cudnn", "nhwc", "dgrad", "fprop")),
    ("cuBLAS / matmul", ("gemm", "cutlass", "cublas", "splitk")),
    ("reductions (SE/head pooling)", ("reduce",)),
    ("elementwise (bias, activations, casts, residuals)",
     ("elementwise", "vectorized", "unrolled")),
)


def phase_profile(torch, pred, imgs, card, calls: int = 3):
    """Where the time of ``predict`` goes: ``torch.profiler`` over a few
    calls of the main path's b128 predictor, device time by kernel class,
    the top kernels, and the device's busy and idle shares of the traced
    window (union of kernel intervals over first start to last end)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pred.predict(imgs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail("the profile holds no device time")
    per_name, per_class = {}, {}
    for e in events:
        us = e.device_time_total
        per_name[e.name] = per_name.get(e.name, 0.0) + us
        label = next((lab for lab, keys in PROFILE_CLASSES
                      if any(k in e.name.lower() for k in keys)), "other")
        per_class[label] = per_class.get(label, 0.0) + us
    busy_us = sum(per_name.values())
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    union, (cur_s, cur_e) = 0.0, spans[0]
    for s, t in spans[1:]:
        if s > cur_e:
            union += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    union += cur_e - cur_s
    window_us = spans[-1][1] - spans[0][0]
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:15]
    emit({"phase": "profile", "batch": imgs.shape[0], "size": SIZE, "calls": calls,
          "wall_ms_per_call": wall_ms / calls,
          "kernel_ms_per_call": busy_us / 1e3 / calls,
          "kernel_launches_per_call": len(events) / calls,
          "device_busy_share": union / window_us,
          "device_idle_share": 1.0 - union / window_us,
          "classes": [{"class": lab, "ms_per_call": us / 1e3 / calls,
                       "share_of_kernel_time": us / busy_us}
                      for lab, us in sorted(per_class.items(), key=lambda kv: -kv[1])],
          "top_kernels": [{"name": n[:120], "ms_per_call": us / 1e3 / calls}
                          for n, us in top],
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: run from a checkout holding {PKG}/", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # fp32 reference math stays fp32 on the card (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import BLOCK_KERNELS
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_like

    t_start = time.perf_counter()
    card = phase_env(torch)
    phase_build()
    weights = init_flax_like(SEED)
    rows = phase_kernels(torch, weights)
    launches, pred, imgs = phase_end_to_end(torch, weights, card)
    phase_profile(torch, pred, imgs, card)

    src = f"{PKG}/csrc"
    meta = {
        "fused_mask_decode": (f"{src}/decoder.cu",
                              "mtg_card_image_segmentation_tpu/ops/pallas/decoder.py:190",
                              launches["fused_mask_decode"]),
        "fused_inverted_residual": (f"{src}/fused_block.cu",
                                    "mtg_card_image_segmentation_tpu/ops/pallas/fused_block.py:515",
                                    sum(launches[n] for n in BLOCK_KERNELS)),
        "fused_tail_chain": (f"{src}/fused_block.cu",
                             "mtg_card_image_segmentation_tpu/ops/pallas/fused_block.py:393",
                             sum(launches[n] for n in BLOCK_KERNELS)),
    }
    kernels = []
    for name, (source, replaces, n) in meta.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
