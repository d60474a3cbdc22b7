#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py        (from the root of a checkout; needs one card)

Builds the hand-written kernels from ``mtg_card_image_segmentation_tpu_torch/
csrc/`` (into ``build/kernels/``), holds each kernel against its plain
PyTorch version on the card at the main paths' shapes, then drives the main
paths with random weights from a seed:

- ``SegPredictor.predict`` at 512x512 with the full-width MobileNetV3-Large +
  LR-ASPP, its masks checked against the port's own CPU predictor and against
  its stock-op reference path;
- ``PosePredictor.predict`` at 480x640 with the full HRNet-W18-small and
  120x160 heatmaps, its heatmaps checked against the port's CPU predictor and
  its decode against the CPU decode of the same heatmaps;
- ``SegPredictor(fused_head=True)``, ``SegPredictor(fused_stem=True)`` and
  both, at 512x512 b128, timed beside the default path and checked against
  its masks.

Last it profiles a few b128 ``predict`` calls of each predictor: device time
by kernel class and the card's idle share.

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
POSE_HW = (480, 640)        # the pose model's published operating point
POSE_HEATMAP_HW = (120, 160)
HEATMAP_TOL = (0.1, 0.01)   # max|d|, mean|d|: card vs CPU bf16 heatmaps of order 1


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


def bf16_ulp(magnitude: float) -> float:
    """One unit in the last place of a bfloat16 of this magnitude (8
    significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(max(magnitude, 1e-30))) - 7)


def timed_launches(name: str, fn, iters: int):
    """(ms, launches): ``cuda_ms`` of ``fn`` with the launch counts zeroed
    before and ``name``'s count read after (warm-up calls included)."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

    _build.reset_launches()
    ms = cuda_ms(fn, iters)
    return ms, _build.LAUNCHES.get(name, 0)


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
        with torch.no_grad():
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

    # free the tail-chain tensors before the large elementwise cases
    del x, got, want, d, xc, blocks, mods, model
    torch.cuda.empty_cache()
    rows.update(phase_io_kernels(torch, weights, rng))
    return rows


def phase_io_kernels(torch, weights, rng):
    """fused_normalize, fused_stem, fused_head_decode and upsample2x_add
    against their plain versions at main-path shapes, each beside its bound
    and the one stock-PyTorch composition of the same function."""
    import numpy as np
    import torch.nn.functional as F

    from mtg_card_image_segmentation_tpu_torch.models.layers import nchw, nhwc
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import decoder as dec
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import preprocess as pre
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import stem as stem_k
    from mtg_card_image_segmentation_tpu_torch.serving import predictor as seg
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

    dev = torch.device("cuda")
    b = BATCHES[-1]
    bf16 = torch.bfloat16
    rows = {}

    # -- fused_normalize: (128, 480, 640, 3) u8 -> bf16 and f32, bit-equal ---
    imgs = torch.from_numpy(rng.integers(0, 256, (b, *POSE_HW, 3), np.uint8)).to(dev)
    n = imgs.numel()
    for dt in (torch.float32, bf16):
        got = pre.fused_normalize(imgs, dt)
        want = pre.fused_normalize_plain(imgs, dt)
        torch.cuda.synchronize()
        if got.dtype != dt or not torch.equal(got, want):
            fail(f"fused_normalize ({dt}) differs from its plain version on "
                 f"{int((got != want).sum())} values")
        err = float((got.float() - want.float()).abs().max())
        del got, want
    scale = torch.from_numpy(pre.SCALE).to(dev)
    shift = torch.from_numpy(pre.SHIFT).to(dev)
    bnd, by = bound(n + 2 * n, fp32_flops=2 * n)
    ms, count = timed_launches("fused_normalize", lambda: pre.fused_normalize(imgs, bf16), 20)
    rows["fused_normalize"] = {
        "ms": ms, "plain_ms": cuda_ms(lambda: pre.fused_normalize_plain(imgs, bf16), 5),
        "library_ms": cuda_ms(lambda: (imgs.float() * scale + shift).to(bf16), 5),
        "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
    emit({"phase": "kernel", "name": "fused_normalize", "shape": list(imgs.shape),
          "out": "bfloat16 (timed) and float32", "exact": True, "launches": count,
          **rows["fused_normalize"]})
    del imgs
    torch.cuda.empty_cache()

    # -- fused_stem: (128, 512, 512, 3) with the predictor's folded weights --
    pred = SegPredictor(*weights, SIZE, SIZE, fused_stem=True)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, SIZE, SIZE, 3), np.uint8)).to(dev)
    kernel, bias = pred._stem
    got = stem_k.fused_stem(imgs, kernel, bias, pred._center, bf16)
    want = stem_k.fused_stem_plain(imgs, kernel, bias, pred._center, bf16)
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    ref_max = float(want.float().abs().max())
    ulp = bf16_ulp(ref_max)
    err, mean_err, differing = float(d.max()), float(d.mean()), int((d > 0).sum())
    del d, want
    if err > ulp or mean_err >= 0.01:
        fail(f"fused_stem: max|d| {err} > one bf16 ulp {ulp} at |out| <= {ref_max}, "
             f"or mean|d| {mean_err} >= 0.01")
    stem_mod = pred.model.backbone.stem

    def stem_library():  # center, cuDNN conv, bias, hardswish
        with torch.no_grad():
            return stem_mod((imgs.float() - pred._center).to(bf16))

    lib_err = float((stem_library().float() - got.float()).abs().max())
    ho = SIZE // 2
    bnd, by = bound(imgs.numel() + b * ho * ho * 16 * 2 + 27 * 16 * 4,
                    fp32_flops=b * ho * ho * 16 * (2 * 27 + 5))
    ms, count = timed_launches(
        "fused_stem", lambda: stem_k.fused_stem(imgs, kernel, bias, pred._center, bf16), 20)
    rows["fused_stem"] = {
        "ms": ms,
        "plain_ms": cuda_ms(lambda: stem_k.fused_stem_plain(imgs, kernel, bias,
                                                            pred._center, bf16), 2, 1),
        "library_ms": cuda_ms(stem_library, 10), "bound_ms": bnd, "bound_by": by,
        "max_abs_err": err}
    emit({"phase": "kernel", "name": "fused_stem", "shape": list(imgs.shape),
          "out": list(got.shape), "mean_abs_err": mean_err, "differing_values": differing,
          "max_abs_ref": ref_max, "one_bf16_ulp": ulp, "library_max_abs_err": lib_err,
          "launches": count, **rows["fused_stem"]})
    del got
    torch.cuda.empty_cache()

    # -- fused_head_decode at b128 with the predictor's real x, gw, low ------
    with torch.inference_mode():
        x = (imgs.float() - pred._center).to(bf16)
        taps = seg._fused_backbone(pred.model.backbone, x, pred._tail)
        low = taps["low"].contiguous()
        feats, gw, w_lo, bias_d = seg._head_gated(pred.model.head, taps["high"],
                                                  pred._head_vectors)
        feats = feats.contiguous()
        del x, taps
        got = dec.fused_head_decode(feats, gw, low, w_lo, bias_d, SIZE, SIZE)
        want = dec.fused_head_decode_plain(feats, gw, low, w_lo, bias_d, SIZE, SIZE)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        if mismatches:
            fail(f"fused_head_decode differs from its plain version on {mismatches} pixels")

        def head_library():  # the stock einsum score, F.interpolate, threshold
            hs = torch.einsum("bhwc,bc->bhw", feats.float(), gw)
            ls = torch.einsum("bhwc,c->bhw", low.float(), w_lo)
            s8 = F.interpolate(hs[:, None], size=ls.shape[1:], mode="bilinear",
                               align_corners=False)[:, 0] + ls + bias_d
            return F.interpolate(s8[:, None], size=(SIZE, SIZE), mode="bilinear",
                                 align_corners=False)[:, 0] > 0

        lib_agree = float((head_library().to(torch.uint8) == got).float().mean())
        h16, h8 = feats.shape[1], low.shape[1]
        c, cl = feats.shape[3], low.shape[3]
        bnd, by = bound(feats.numel() * 2 + low.numel() * 2 + gw.numel() * 4 + b * SIZE * SIZE,
                        fp32_flops=2 * b * (h16 * h16 * c + h8 * h8 * cl)
                        + 9 * b * h8 * h8 + 3 * b * SIZE * (h8 + SIZE))
        ms, count = timed_launches(
            "fused_head_decode",
            lambda: dec.fused_head_decode(feats, gw, low, w_lo, bias_d, SIZE, SIZE), 20)
        rows["fused_head_decode"] = {
            "ms": ms,
            "plain_ms": cuda_ms(lambda: dec.fused_head_decode_plain(
                feats, gw, low, w_lo, bias_d, SIZE, SIZE), 3, 1),
            "library_ms": cuda_ms(head_library, 10), "bound_ms": bnd, "bound_by": by,
            "max_abs_err": float((got.float() - want.float()).abs().max())}
    emit({"phase": "kernel", "name": "fused_head_decode", "x": list(feats.shape),
          "low": list(low.shape), "out": list(got.shape), "exact": True,
          "foreground_fraction": float(got.float().mean()),
          "agreement_with_library": lib_agree, "launches": count,
          **rows["fused_head_decode"]})
    del imgs, feats, low, got, want, pred
    torch.cuda.empty_cache()

    # -- upsample2x_add at the head-merge shape (128,32,32,128)+(128,64,64,128)
    h = SIZE // 16
    high32 = torch.from_numpy(rng.standard_normal((b, h, h, 128)).astype(np.float32)).to(dev)
    low32 = torch.from_numpy(rng.standard_normal((b, 2 * h, 2 * h, 128))
                             .astype(np.float32)).to(dev)
    d = (dec.upsample2x_add(high32, low32) - dec.upsample2x_add_plain(high32, low32)).abs()
    err32 = float(d.max())
    if err32 > 1e-5:
        fail(f"upsample2x_add float32: max|d| {err32} > 1e-5")
    high, low = high32.to(bf16), low32.to(bf16)
    del high32, low32, d
    got = dec.upsample2x_add(high, low)
    want = dec.upsample2x_add_plain(high, low)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ulp = bf16_ulp(float(want.float().abs().max()))
    if got.dtype != bf16 or err > ulp:
        fail(f"upsample2x_add bfloat16: max|d| {err} > one ulp {ulp}")

    def up_library():
        return nhwc(F.interpolate(nchw(high), scale_factor=2, mode="bilinear",
                                  align_corners=False)) + low

    lib_err = float((up_library().float() - want.float()).abs().max())
    bnd, by = bound(high.numel() * 2 + 2 * low.numel() * 2, fp32_flops=10 * low.numel())
    ms, count = timed_launches("upsample2x_add", lambda: dec.upsample2x_add(high, low), 20)
    rows["upsample2x_add"] = {
        "ms": ms, "plain_ms": cuda_ms(lambda: dec.upsample2x_add_plain(high, low), 3),
        "library_ms": cuda_ms(up_library, 10), "bound_ms": bnd, "bound_by": by,
        "max_abs_err": err, "launches": count}
    emit({"phase": "kernel", "name": "upsample2x_add", "high": list(high.shape),
          "low": list(low.shape), "dtype": "bfloat16 (timed) and float32",
          "max_abs_err_float32": err32, "one_bf16_ulp": ulp,
          "library_max_abs_err": lib_err, **rows["upsample2x_add"]})
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


def phase_pose_end_to_end(torch, pose_weights, card):
    """PosePredictor.predict at 480x640 (120x160 heatmaps) through the
    normalize kernel, with the launch count of the run; the card's heatmaps
    against the port's CPU path, and the card's decode against the CPU
    decode of the same heatmaps."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import PosePredictor

    params, stats = pose_weights
    h, w = POSE_HW
    pred = PosePredictor(params, stats, h, w, heatmap_hw=POSE_HEATMAP_HW)
    launches = {}
    for b in BATCHES:
        imgs = np.random.default_rng(SEED + 1000 + b).integers(0, 256, (b, h, w, 3), np.uint8)
        dev_imgs = torch.from_numpy(imgs).cuda()
        pred.predict(dev_imgs)  # first call: cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls = 5
        _build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(calls):
            px, conf = pred.predict(dev_imgs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / calls
        counts = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if counts.get("fused_normalize", 0) <= 0:
            fail(f"pose path at b{b} launched no fused_normalize: {counts}")
        if (px.dtype, conf.dtype) != (torch.float32, torch.float32) \
                or tuple(px.shape) != (b, 4, 2) or tuple(conf.shape) != (b, 4):
            fail(f"pose outputs {px.dtype} {tuple(px.shape)}, {conf.dtype} {tuple(conf.shape)}")
        if not (bool(torch.isfinite(px).all()) and bool(torch.isfinite(conf).all())):
            fail("pose outputs are not finite")
        if float(px.min()) < 0 or float(px[..., 0].max()) > w - 1 or float(px[..., 1].max()) > h - 1:
            fail("pose corners lie outside the image")
        launches[b] = counts
        emit({"phase": "pose_end_to_end", "batch": b, "size": [h, w],
              "heatmap": list(POSE_HEATMAP_HW), "calls": calls, "ms_per_batch": ms,
              "img_per_s": b * 1e3 / ms, "peak_mem_bytes": peak, "launches": counts,
              "mean_conf": float(conf.mean()),
              "card": card["name"], "nvidia_smi": card["nvidia_smi"]})

    # the card's kernel path against the port's CPU path: same weights, same
    # bf16 dtype, 4 images. Random weights give flat heatmaps whose arg-max
    # can move for no fault of the port, so the heatmaps are gated, and the
    # decode is gated apart, on identical heatmaps.
    imgs = np.random.default_rng(SEED + 1000).integers(0, 256, (4, h, w, 3), np.uint8)
    cpu = PosePredictor(params, stats, h, w, heatmap_hw=POSE_HEATMAP_HW, device="cpu")
    t0 = time.perf_counter()
    hm_card = pred.heatmaps(imgs)
    hm_cpu = cpu.heatmaps(imgs)
    d = (hm_card.cpu() - hm_cpu).abs()
    px_card, conf_card = pred.decode(hm_card)
    px_cpu, conf_cpu = cpu.decode(hm_card.cpu())
    d_px = float((px_card.cpu() - px_cpu).abs().max())
    d_conf = float((conf_card.cpu() - conf_cpu).abs().max())
    emit({"phase": "pose_card_vs_cpu", "images": 4, "heatmaps": list(hm_card.shape),
          "heatmap_max_abs": float(hm_cpu.abs().max()),
          "heatmap_max_abs_err": float(d.max()), "heatmap_mean_abs_err": float(d.mean()),
          "decode_max_abs_err_px": d_px, "decode_max_abs_err_conf": d_conf,
          "seconds": time.perf_counter() - t0})
    if tuple(hm_card.shape) != (4, *POSE_HEATMAP_HW, 4) or hm_card.dtype != torch.float32:
        fail(f"heatmaps {hm_card.dtype} {tuple(hm_card.shape)}")
    if float(d.max()) > HEATMAP_TOL[0] or float(d.mean()) > HEATMAP_TOL[1]:
        fail(f"card vs CPU heatmaps: max|d| {float(d.max())}, mean|d| {float(d.mean())} "
             f"above {HEATMAP_TOL}")
    if d_px > 1e-3 or d_conf > 1e-6:
        fail(f"card vs CPU decode of the same heatmaps: {d_px} px, {d_conf} conf")
    return launches[BATCHES[-1]], pred, dev_imgs


def phase_seg_options(torch, weights, default, imgs, card):
    """SegPredictor(fused_head=True), (fused_stem=True) and both at 512x512
    b128: ms/batch beside the default path's (timed in turns within this
    phase), their kernels' launch counts, and mask agreement with the
    default path on the card."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

    variants = {
        "default": ({}, (), 0.0),
        "fused_head": ({"fused_head": True}, ("fused_head_decode",), 0.999),
        "fused_stem": ({"fused_stem": True}, ("fused_stem",), 0.99),
        "fused_head+fused_stem": ({"fused_head": True, "fused_stem": True},
                                  ("fused_head_decode", "fused_stem"), 0.99),
    }
    preds = {name: default if name == "default" else SegPredictor(*weights, SIZE, SIZE, **kw)
             for name, (kw, _, _) in variants.items()}
    base = default.predict(imgs)
    calls, rounds = 5, 2
    ms = {name: [] for name in variants}
    launches = {}
    for r in range(rounds):
        order = list(variants) if r % 2 == 0 else list(variants)[::-1]
        for name in order:
            pred = preds[name]
            pred.predict(imgs)
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            for _ in range(calls):
                masks = pred.predict(imgs)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / calls)
            launches[name] = dict(_build.LAUNCHES)
    total = {}
    for name, (_, needed, floor) in variants.items():
        counts = launches[name]
        missing = [n for n in needed if counts.get(n, 0) <= 0]
        if missing:
            fail(f"SegPredictor({name}) launched no {missing}: {counts}")
        for n in needed:
            total[n] = total.get(n, 0) + counts[n]
        if "fused_head_decode" in needed and counts.get("fused_mask_decode", 0):
            fail(f"SegPredictor({name}) still launched fused_mask_decode")
        masks = preds[name].predict(imgs)
        agree = float((masks == base).float().mean())
        if masks.dtype != torch.uint8 or tuple(masks.shape) != tuple(base.shape):
            fail(f"SegPredictor({name}) masks {masks.dtype} {tuple(masks.shape)}")
        if agree < floor:
            fail(f"SegPredictor({name}) agreement with the default path {agree} < {floor}")
        emit({"phase": "seg_options", "variant": name, "batch": imgs.shape[0], "size": SIZE,
              "calls": calls, "ms_per_batch_rounds": ms[name],
              "ms_per_batch": min(ms[name]), "launches": counts,
              "agreement_vs_default": agree, "agreement_floor": floor,
              "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    return total


# profiled kernel-name fragments -> class, first match wins
PROFILE_CLASSES = (
    ("tail chain: expand/project GEMM (pw_gemm_kernel)", ("pw_gemm_kernel",)),
    ("tail chain: depthwise + SE sums (depthwise_kernel)", ("depthwise_kernel",)),
    ("tail chain: SE gate (se_gate_kernel)", ("se_gate_kernel",)),
    ("mask decode (mask_decode_kernel)", ("mask_decode_kernel",)),
    ("normalize (normalize_kernel)", ("normalize_kernel",)),
    ("stem (stem_kernel)", ("stem_kernel",)),
    ("head decode (head_decode_kernel)", ("head_decode_kernel",)),
    ("batch norm (cuDNN inference kernel)", ("bn_fw", "batch_norm", "batchnorm")),
    ("gathers (nearest and bilinear resize, decode)", ("index", "gather")),
    ("cuDNN convolutions", ("conv", "xmma", "implicit", "cudnn", "nhwc", "dgrad", "fprop")),
    ("cuBLAS / matmul", ("gemm", "cutlass", "cublas", "splitk")),
    ("reductions (SE/head pooling)", ("reduce",)),
    ("elementwise (bias, activations, casts, residuals)",
     ("elementwise", "vectorized", "unrolled")),
)


def phase_profile(torch, pred, imgs, card, calls: int = 3):
    """Where the time of ``predict`` goes: ``torch.profiler`` over a few
    calls of one main path's b128 predictor, device time by kernel class,
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
    emit({"phase": "profile", "predictor": type(pred).__name__, "batch": imgs.shape[0],
          "size": list(imgs.shape[1:3]), "calls": calls,
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
    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        init_flax_like,
        init_hrnet_flax_like,
    )

    t_start = time.perf_counter()
    card = phase_env(torch)
    phase_build()
    weights = init_flax_like(SEED)
    rows = phase_kernels(torch, weights)
    launches, pred, imgs = phase_end_to_end(torch, weights, card)
    phase_profile(torch, pred, imgs, card)
    option_launches = phase_seg_options(torch, weights, pred, imgs, card)
    del pred, imgs
    torch.cuda.empty_cache()
    pose_launches, pose_pred, pose_imgs = phase_pose_end_to_end(
        torch, init_hrnet_flax_like(SEED), card)
    phase_profile(torch, pose_pred, pose_imgs, card)

    # per kernel: source, the TPU kernel it replaces, and its launches on
    # the main path that runs it (upsample2x_add has no caller in the
    # package: its launches are those of the kernel phase's timed run)
    src, ref = f"{PKG}/csrc", "mtg_card_image_segmentation_tpu/ops/pallas"
    meta = {
        "fused_mask_decode": (f"{src}/decoder.cu", f"{ref}/decoder.py:190",
                              launches["fused_mask_decode"]),
        "fused_inverted_residual": (f"{src}/fused_block.cu", f"{ref}/fused_block.py:515",
                                    sum(launches[n] for n in BLOCK_KERNELS)),
        "fused_tail_chain": (f"{src}/fused_block.cu", f"{ref}/fused_block.py:393",
                             sum(launches[n] for n in BLOCK_KERNELS)),
        "fused_normalize": (f"{src}/preprocess.cu", f"{ref}/preprocess.py:37",
                            pose_launches["fused_normalize"]),
        "fused_stem": (f"{src}/stem.cu", f"{ref}/stem.py:186", option_launches["fused_stem"]),
        "fused_head_decode": (f"{src}/decoder.cu", f"{ref}/decoder.py:122",
                              option_launches["fused_head_decode"]),
        "upsample2x_add": (f"{src}/decoder.cu", f"{ref}/decoder.py:58",
                           rows["upsample2x_add"]["launches"]),
    }
    kernels = []
    for name, (source, replaces, n) in meta.items():
        r = rows[name]
        if n <= 0:
            fail(f"{name} was launched no time on its path")
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
