#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py        (from the root of a checkout; needs one card)

Builds the hand-written kernels from ``mtg_card_image_segmentation_tpu_torch/
csrc/`` (into ``build/kernels/``), holds each kernel against its plain
PyTorch version on the card at the main paths' shapes (the block kernels
also at the server's one-image and two-image 20x15 maps, where a 128-row
GEMM tile spans two images with different SE gates, and the GEMM on its own
at K and N of 472; the tail chain's four kernels timed one by one beside
their byte floors, ``fused_tail_chain_steps``; the stem also at 320x240 b128
and b1, at 40x24, whose 72-byte rows take the kernel's 4-byte load path,
and on 1- and 2-image slices of the b128 batch, bit for bit; the head decode
also at 320x240 b128 and b1 from that predictor's features and at a ragged
160x128), then drives the main paths with random weights from a seed:

- ``SegPredictor.predict`` at 512x512 with the full-width MobileNetV3-Large +
  LR-ASPP, its masks checked against the port's own CPU predictor and against
  its stock-op reference path;
- ``PosePredictor.predict`` at 480x640 with the full HRNet-W18-small and
  120x160 heatmaps, its heatmaps checked against the port's CPU predictor and
  its decode against the CPU decode of the same heatmaps;
- ``SegPredictor(fused_head=True)``, ``SegPredictor(fused_stem=True)`` and
  both, at 512x512 b128, timed beside the default path and checked against
  its masks;
- the serving modes at 512x512 b128 (``seg_modes``): int8 weights against the
  bf16 predictor, slim (channel-pruned) widths against the masked dense model
  and against their own stock-op path;
- the per-block kernel on every backbone block and the predictor's
  ``fused_blocks``/``fused_chain`` options (``seg_fused_blocks``): blocks
  0-14 alone at their 512x512 b128 inputs (and 1, 6, 13 at 320x240 b32)
  against their plain versions, timed beside the stock module and their
  bound; ``SegPredictor(fused_blocks=range(15))`` at 512x512 b128 beside the
  default path and at 320x240 b32, with exact launch counts, against the
  default path and the CPU path; ``fused_chain=False`` block by block
  against the chain (row 3's own ``launches_by_path``);
- ``SegPredictor.predict`` at the server's default 320x240 (``seg_320x240``);
- the HTTP server (``server``): checkpoints written with ``save_params``,
  ``DemoServer`` started through ``from_checkpoint`` on 127.0.0.1, ``/healthz``,
  ``POST /api/segment`` and ``POST /api/corners`` (HRNet, then a second server
  with ``--pose-family yolo``) with PNG bodies, serially and from two threads
  at once, every answer checked against the predictor called directly, and
  that one-image call against the port's CPU predictor from the same
  checkpoint (kernels 1-4 are also held against their plain versions at
  these one-image shapes in the kernel phase);
- ``YoloCornerPredictor.predict`` at 640x640 (``yolo_end_to_end``,
  ``yolo_card_vs_cpu``);
- ``tools/stencil_floor_torch.py`` (``stencil_tool``), the card's depthwise
  stencil microbenchmark;
- segmentation training (``train_*``): ``SegTrainer`` at 320x240 b32, its
  checkpoint served;
- the data path at 320x240 b32 (``data``): the renderer, the augmented
  render, ``augment_batch`` and ``preprocess_batch`` on the card against the
  CPU on the same draws, the warps against numpy, ``SyntheticPipeline`` and
  ``FilePipeline`` (96 JPEG frames at 480x640 that the phase writes) timed,
  the draws' rates;
- ``train_seg_torch.py`` in subprocesses (``train_cli``): the synthetic
  source, a resume, the file source, and the synthetic run's checkpoint
  served through kernels 1-3 (``launches_by_path``'s ``train_cli_served``);
- ``evaluate_seg_torch.py``, ``prune_seg_torch.py`` and
  ``export_seg_torch.py`` in subprocesses on that checkpoint
  (``compress_export``): evaluation on both sources (and the evaluator
  card vs CPU in this process), expansion pruning with a masked fine-tune
  and magnitude pruning, the ONNX package of the slimmed pruned model and
  of the dense one, each gated by the CLI with the torch executor on the
  card; then the pruned model slimmed and served through kernels 1-3
  (``compress_export_served``), held against the CPU and against its
  exported graph;
- HRNet pose training and its CLIs at the pose config, 480x640 b24
  (``pose_pipeline``): one train step card vs CPU at b4, the loss and
  the BN statistics in fp32, the gradients in float64
  (``pose_train_fp32_card_vs_cpu``), ``train_pose_torch.py`` for 2 epochs x
  8 steps and a resumed third in two subprocesses, the trained checkpoint
  served through kernel 4 (``pose_train_served``) card vs CPU,
  ``PoseEvaluator`` card vs CPU, ``export_pose_torch.py`` with every
  artifact card vs CPU, ``pose_inference_torch.py`` and
  ``seg_inference_torch.py`` on packages (the ladder must choose the int8
  rung and fall past nothing) and on checkpoints, and the pose train
  step's numbers and profile;
- YOLO12n-pose training and its CLIs at the default config, 640x640 b32
  (``yolo_pipeline``): one train step card vs CPU at b4 under the pose
  step's rules (``yolo_train_fp32_card_vs_cpu``), ``train_yolo_torch.py``
  for 2 epochs x 8 steps and a resumed third, the trained checkpoint
  served through ``YoloCornerPredictor`` card vs CPU, ``CornerEvaluator``
  card vs CPU, ``export_yolo_torch.py`` with its artifacts card vs CPU,
  ``pose_inference_torch.py --family yolo`` on the package (int8 rung, no
  fall) and on the checkpoint, and the YOLO train step's numbers and
  profile. The YOLO path launches none of the hand-written kernels;
- the ``torch.export`` programs (``.pt2``) the three export CLIs write at
  full width: each CLI's self-test on the card, ``--pt2`` against
  ``--checkpoint`` in float32 and each program against its model
  (``program_clis``), a CPU-exported YOLO program on the card and the
  card-exported one on the CPU (``yolo_program_devices``), YOLO ``--pt2``
  against its fp32 ONNX graph;
- data-parallel training and batch-split serving (``distributed``): the
  seg fp32 train step at 320x240 b32 in an NCCL group of one rank and in a
  gloo group of two ranks on the one card (this script's
  ``distributed-worker`` mode), against the plain step and its float64
  step, and ``SegPredictor(mesh=make_mesh())`` through kernels 1-3;
- the mesh's spatial axis (``space``): two gloo ranks on the one card
  (``space-worker`` mode), mesh (data=1, space=2), the rows of every map
  split between them with halo rows exchanged through the host: the seg
  fp32 step at 320x240 b32 and the full HRNet's at 480x640 b4 (an uneven
  15-row s32 branch), held by the ``distributed`` rule, the float64
  sharded seg step against the plain one to 1e-12, each step's ms and the
  row exchanges' share of it;
- the graft entry, the block profiler and the data-generation surfaces
  (``tools``): ``graft_entry_torch.entry()`` card vs CPU,
  ``tools/profile_blocks_torch.py`` at 512x512 b128 (kernels 4 and 1,
  ``launches_by_path``'s ``profile_blocks``),
  ``tools/profile_pose_step_torch.py`` at b24, ``generate_dataset_torch.py``
  at 320x240 and its resume, ``tta_batch`` card vs CPU, and the plot CLIs'
  computation (a checkpoint's prediction grid card vs CPU); then
  ``tools/half_conv_layout_torch.py``, every half-precision conv the port
  runs in NCHW and channels_last against float64 (a layout the port runs
  that is wrong fails the phase); ``tools/make_slim_fixture_torch.py`` as a
  CLI and its checkpoint served at 512x512 b128 through kernels 2 and 1
  (``slim_fixture_served``, exact launches, the kernels against their plain
  versions on the inputs of that predict, masks against the CPU path) and
  profiled through kernels 4 and 1 (``slim_fixture_profile``); and
  ``tools/make_decode_fixtures_torch.py`` (both families) and
  ``tools/analyze_dead_channel_torch.py``'s analysis on the pose and YOLO
  checkpoints of the earlier phases, the fixtures' indices against the CPU
  selection on the same card outputs.

It also profiles a few b128 ``predict`` calls of the three
predictors: device time by kernel class and the card's idle share.

Every phase prints one JSON line (the redesigned kernels' lines carry
``prev_ms_pr3_recorded`` or ``prev_ms_pr4_recorded``, their time before
the redesign as recorded from an earlier run of this script, not measured
here; the chain's line and
``fused_tail_chain_steps`` carry ``floor_b_ms``, the byte floor of its
design). Then come the kernels' summary line (every number in it measured
or computed in this run), the
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` line, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that last line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext
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
SERVER_HW = (320, 240)      # the server's default segmentation size
YOLO_SIZE = 640
YOLO_LEVEL_TOL = (0.25, 0.02)  # max|d|, mean|d|: card vs CPU bf16 level outputs of order 5
# stencil_floor against its plain version: outputs of order 5e-3 to 8e-2. Both
# round y = x @ w_exp to bf16 from float32 sums taken in another order, so a y
# within float32 rounding of a bf16 tie rounds the other way: one such flip at
# |y| in [2, 4) moves `pass` by 2^-6/960 = 1.63e-5. The gate allows two in one
# pixel, and holds the mean, which a wrong tap or shift would move, at 1e-6.
STENCIL_TOL = (4e-5, 1e-6)
# the kernels' times before their redesign: recorded from an earlier run of
# this script's kernel phase (NVIDIA H100 80GB HBM3, 700.00 W, b128 main-path
# shapes), not measured by this run; printed in the kernel lines only, as
# prev_ms_pr3_recorded
PREV_MS = {"fused_mask_decode": 0.300, "fused_tail_chain": 7.141,
           "fused_inverted_residual": 2.633,
           "stencil_floor": {"pass": 0.58, "arith": 1.62, "full": 2.11}}
# stencil_floor's ragged case: rows that fill no strip, W not a multiple of 16,
# three channel slices; inputs drawn as the stencil tool draws its own
STENCIL_RAGGED = ((3, 20, 48, 64), 192, 5, 2)
# the same, for the kernels redesigned or changed after that run, from the
# run that preceded their change (same card and shapes), printed as
# prev_ms_pr4_recorded
PREV_MS_PR4 = {"fused_mask_decode": 0.0418, "fused_stem": 0.552, "fused_head_decode": 0.341}


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


def gc_timer():
    """Start timing the interpreter's garbage collections; the function it
    returns stops the timing and gives their count, the full (generation 2)
    ones and the longest pause. A full collection stops every thread, so one
    in a request window shows as a stall of every request in flight."""
    import gc

    pauses, start = [], [0.0]

    def cb(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], (time.perf_counter() - start[0]) * 1e3))

    gc.callbacks.append(cb)

    def stop() -> dict:
        gc.callbacks.remove(cb)
        return {"collections": len(pauses), "full": sum(g == 2 for g, _ in pauses),
                "max_pause_ms": max((ms for _, ms in pauses), default=0.0)}

    return stop


def timed_launches(name: str, fn, iters: int):
    """(ms, launches): ``cuda_ms`` of ``fn`` with the launch counts zeroed
    before and ``name``'s count read after (warm-up calls included)."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

    _build.reset_launches()
    ms = cuda_ms(fn, iters)
    return ms, _build.LAUNCHES.get(name, 0)


def chain_steps(torch, fb, x, blocks) -> dict:
    """The tail chain's four kernels one at a time, at its main-path shape:
    each step timed alone on the inputs the chain gives it (CUDA events),
    summed over the blocks, beside its byte floor (every byte it must read
    or write, once, over the HBM rate). ``floor_b_ms`` is their sum, the
    floor of design (b) (maps through HBM in bf16) for the whole chain."""
    bf16, f32 = torch.bfloat16, torch.float32
    b, h, w, _ = x.shape
    m, dev = b * h * w, x.device
    steps = {n: {"ms": 0.0, "floor_ms": 0.0, "gbytes": 0.0} for n in fb.BLOCK_KERNELS}

    def add(name, fn, nbytes):
        steps[name]["ms"] += cuda_ms(fn, 20)
        steps[name]["gbytes"] += nbytes / 1e9
        steps[name]["floor_ms"] += nbytes / HBM_BYTES_PER_S * 1e3

    val, val_bf16 = x, x
    for i, bw in enumerate(blocks):
        last = i == len(blocks) - 1
        cin, cexp, cout = bw.cin, bw.cexp, bw.cout
        res = val if cin == cout else None
        y = torch.empty((b, h, w, cexp), dtype=bf16, device=dev)
        add("expand_gemm", lambda: fb._gemm(val_bf16, bw.exp_w, bw.exp_b, None, 0, None, y,
                                            "hardswish", "expand_gemm"),
            m * cin * 2 + cexp * cin * 2 + cexp * 4 + m * cexp * 2)
        dw, sums, nb = fb._depthwise(y, bw, 1, "hardswish", 2)
        add("depthwise", lambda: fb._depthwise(y, bw, 1, "hardswish", 2),
            2 * m * cexp * 2 + 25 * cexp * 2 + cexp * 4 + b * nb * cexp * 4)
        se_w = sum(t.numel() * 4 for t in (bw.se1_w, bw.se1_b, bw.se2_w, bw.se2_b))
        gate = fb._se_gate(sums, nb, h * w, bw)
        add("se_gate", lambda: fb._se_gate(sums, nb, h * w, bw),
            b * nb * cexp * 4 + se_w + b * cexp * 2)
        out = torch.empty((b, h, w, cout), dtype=bf16 if last else f32, device=dev)
        copy = None if last else torch.empty((b, h, w, cout), dtype=bf16, device=dev)
        add("project_gemm", lambda: fb._gemm(dw, bw.proj_w, bw.proj_b, gate, h * w, res, out,
                                             None, "project_gemm", copy),
            m * cexp * 2 + b * cexp * 2 + cout * cexp * 2 + cout * 4
            + (m * cout * res.element_size() if res is not None else 0)
            + m * cout * out.element_size() + (m * cout * 2 if copy is not None else 0))
        val, val_bf16 = (out, out) if last else (out, copy)
    return {"steps": steps, "steps_ms": sum(v["ms"] for v in steps.values()),
            "floor_b_ms": sum(v["floor_ms"] for v in steps.values())}


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
    spilled = [k for k in kernels if k["fn"].startswith("stencil_floor_kernel")
               and (k["spill_stores"] or k["spill_loads"])]
    if spilled:
        fail(f"stencil_floor_kernel spills registers: {spilled}")
    emit({"phase": "build", "seconds": round(seconds, 3),
          "per_source_seconds": {k: round(v["seconds"], 3) for k, v in info.items()},
          "kernels": kernels})


def phase_kernels(torch, weights):
    """Each kernel against its plain version on the card, at the main
    path's shapes; times from CUDA events."""
    import numpy as np
    import torch.nn.functional as F

    from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import decoder as dec
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import fused_block as fb
    from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows = {}

    # the card idles through the build: half a second of matmuls brings its
    # clocks up before the first timing (the decode's, a few ms in all)
    warm = torch.ones((4096, 4096), dtype=torch.bfloat16, device=dev)
    t_end = time.perf_counter() + 0.5
    while time.perf_counter() < t_end:
        for _ in range(20):
            warm @ warm
        torch.cuda.synchronize()
    del warm

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
          "plan": dec.mask_decode_plan(b, h, h, SIZE, SIZE, _build.sm_count(dev)),
          "prev_ms_pr3_recorded": PREV_MS["fused_mask_decode"],
          "prev_ms_pr4_recorded": PREV_MS_PR4["fused_mask_decode"],
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
        h, w = hw if isinstance(hw, tuple) else (hw, hw)
        x = torch.from_numpy(rng.standard_normal((n, h, w, blk.in_features))
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

    # kernel sizes the model does not use (the depthwise's run-time-k
    # instance; 3 and 5 are unrolled): k = 7 and 1, seeded random weights
    krng = np.random.default_rng(SEED + 11)
    for k, st, dil in ((7, 1, 1), (7, 2, 1), (7, 1, 2), (1, 1, 1)):
        tree = {name: {"conv": {  # HWIO kernels, LeCun-normal over their fan-in
            "kernel": (krng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.1 * krng.standard_normal(shape[-1])).astype(np.float32)}}
            for name, shape, fan_in in (("expand", (1, 1, 24, 64), 24),
                                        ("depthwise", (k, k, 1, 64), k * k),
                                        ("project", (1, 1, 64, 24), 64))}
        bw = fb.BlockWeights.from_flax(tree, k, dev)
        x = torch.from_numpy(krng.standard_normal((8, 16, 16, 24)).astype(np.float32)).to(
            dev, torch.bfloat16)
        got = fb.fused_inverted_residual(x, bw, k, st, "hardswish", st == 1, dil)
        want = fb.inverted_residual_plain(x, bw, st, "hardswish", st == 1, dil, torch.bfloat16)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        ok = float(d.max()) <= TOL
        emit({"phase": "kernel", "name": "fused_inverted_residual", "block": None,
              "shape": list(x.shape), "k": k, "stride": st, "dilation": dil, "se": False,
              "act": "hardswish", "residual": st == 1, "max_abs_err": float(d.max()),
              "max_abs_ref": float(want.float().abs().max()), "within_tol": ok})
        if not ok:
            fail(f"fused_inverted_residual k={k} stride {st} dilation {dil}: "
                 f"max|d| {float(d.max())} > {TOL}")

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
          "prev_ms_pr3_recorded": PREV_MS["fused_inverted_residual"],
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
    steps = chain_steps(torch, fb, x, blocks)
    rows["fused_tail_chain"] = {
        "ms": cuda_ms(lambda: fb.fused_tail_chain(x, blocks, 5, "hardswish", 2), 20),
        "plain_ms": cuda_ms(lambda: fb.tail_chain_plain(x, blocks, "hardswish", 2), 3),
        "library_ms": cuda_ms(library_chain, 20), "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float(d.max())}
    emit({"phase": "kernel", "name": "fused_tail_chain", "shape": list(x.shape),
          "gflop_tensor": tflops / 1e9, "gflop_fp32": fflops / 1e9,
          "max_abs_ref": float(want.float().abs().max()),
          "library_max_abs_err": lib_err, "floor_b_ms": steps["floor_b_ms"],
          "prev_ms_pr3_recorded": PREV_MS["fused_tail_chain"], **rows["fused_tail_chain"]})
    emit({"phase": "kernel", "name": "fused_tail_chain_steps", "shape": list(x.shape), **steps})

    # -- K1/K4 on their own at widths the tiling must take: K and N of 472
    # (slim block 12), 600 rows (two images of 300: the 128-row tiles 256-383
    # straddle them, each image with its own gate), against the plain GEMM ---
    gemm_cases = []
    for mm, kk, nn, gated in ((600, 112, 472, False), (600, 472, 160, True),
                              (b * 1024, 112, 472, False), (b * 1024, 472, 160, True)):
        g = torch.Generator(device="cpu").manual_seed(mm + kk + nn)
        a = torch.randn(mm, kk, generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn(nn, kk, generator=g) / kk ** 0.5).to(dev, torch.bfloat16)
        bias = torch.randn(nn, generator=g).to(dev)
        rpi = 300 if mm == 600 else 1024
        gate = (torch.rand(mm // rpi, kk, generator=g).to(dev, torch.bfloat16)
                if gated else None)
        res = torch.randn(mm, nn, generator=g).to(dev) if gated else None
        act, odt = (None, torch.float32) if gated else ("hardswish", torch.bfloat16)
        got = fb.pw_gemm(a, wt, bias, gate, rpi, res, act, odt)
        want = fb.pw_gemm_plain(a, wt, bias, gate, rpi, res, act, odt)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        plan = fb.gemm_plan(mm, nn, kk, gated, _build.sm_count(dev))
        case = {"m": mm, "k": kk, "n": nn, "gated": gated, "max_abs_err": err,
                "max_abs_ref": float(want.float().abs().max()),
                "plan": {k2: plan[k2] for k2 in ("bn", "n_tiles", "stages", "resident",
                                                 "k_pad16", "smem_bytes", "grid")},
                "within_tol": err <= TOL}
        gemm_cases.append(case)
        if err > TOL:
            fail(f"pw_gemm {mm}x{kk}x{nn} (gated {gated}): max|d| {err} (gate {TOL})")
    emit({"phase": "kernel", "name": "pw_gemm", "cases": gemm_cases})

    # -- slim widths: block 12 at 471 expanded channels and the slim chain
    # (471/672/672, widened to 472 inside BlockWeights) on the kernels -------
    from mtg_card_image_segmentation_tpu_torch.compression.slim import (
        expansion_channel_prune,
        slim_seg_state,
    )

    pruned, _ = expansion_channel_prune(weights[0], 0.3)
    slim_params, slim_stats, overrides = slim_seg_state(pruned, weights[1])
    if overrides[12:] != (471, 672, 672):
        fail(f"slim widths of the tail are {overrides[12:]}, want (471, 672, 672)")
    sbb = fold_batch_norm(slim_params, slim_stats)["backbone"]
    sblocks = [fb.BlockWeights.from_flax(sbb[f"block{i}"], 5, dev) for i in (12, 13, 14)]
    _build.reset_launches()
    got = fb.fused_inverted_residual(x, sblocks[0], 5, 1, "hardswish", False, 2)
    want = fb.inverted_residual_plain(x, sblocks[0], 1, "hardswish", False, 2, torch.bfloat16)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    err = float((got.float() - want.float()).abs().max())
    emit({"phase": "kernel", "name": "fused_inverted_residual", "block": 12,
          "expanded": 471, "padded_to": sblocks[0].cexp, "shape": list(x.shape),
          "max_abs_err": err, "launches": counts, "within_tol": err <= TOL})
    if err > TOL or any(counts.get(n, 0) != 1 for n in fb.BLOCK_KERNELS):
        fail(f"block 12 at width 471: max|d| {err} (gate {TOL}), launches {counts}")
    _build.reset_launches()
    got = fb.fused_tail_chain(x, sblocks, 5, "hardswish", 2)
    want = fb.tail_chain_plain(x, sblocks, "hardswish", 2)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    err = float((got.float() - want.float()).abs().max())
    emit({"phase": "kernel", "name": "fused_tail_chain", "widths": list(overrides[12:]),
          "shape": list(x.shape), "max_abs_err": err, "launches": counts,
          "ms": cuda_ms(lambda: fb.fused_tail_chain(x, sblocks, 5, "hardswish", 2), 20),
          "within_tol": err <= TOL})
    if err > TOL or any(counts.get(n, 0) != 3 for n in fb.BLOCK_KERNELS):
        fail(f"slim chain: max|d| {err} (gate {TOL}), launches {counts}")

    # -- the HTTP server's shapes: one image per request. At 320x240 the tail
    # map is 20x15, so the GEMMs see M = 300 rows (not a multiple of their
    # 16-row tile: the guarded last tile) and the depthwise an odd width; the
    # decode goes (1,40,30) -> (1,320,240); the corners' normalize sees
    # (1,480,640,3). Wrapper against plain, with the launches of each call ----
    tail_hw = (SERVER_HW[0] // 16, SERVER_HW[1] // 16)
    for i, n_img in ((12, 1), (13, 1), (13, 2)):
        blk, bw, x1, (bw, k, st, act, res, dil) = block_case(i, n_img, tail_hw)
        _build.reset_launches()
        got = fb.fused_inverted_residual(x1, bw, k, st, act, res, dil)
        counts = dict(_build.LAUNCHES)
        want = fb.inverted_residual_plain(x1, bw, st, act, res, dil, torch.bfloat16)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        extra = {}
        if n_img == 2:  # the project's 128-row tile 256-383 holds rows of both images
            dw, sums, nbands = fb._depthwise(fb.pw_gemm(x1, bw.exp_w, bw.exp_b, act=act,
                                                        name="expand_gemm").view(
                *x1.shape[:3], bw.cexp), bw, 1, act, dil)
            gate = fb._se_gate(sums, nbands, dw.shape[1] * dw.shape[2], bw)
            extra = {"rows_per_image": dw.shape[1] * dw.shape[2],
                     "gates_differ": int((gate[0] != gate[1]).sum())}
            if extra["gates_differ"] == 0:
                fail("the two images of the (2,20,15) case share their SE gate")
        emit({"phase": "kernel", "name": "fused_inverted_residual", "block": i,
              "path": "server", "shape": list(x1.shape), "gemm_rows": x1[..., 0].numel(),
              "max_abs_err": err, "max_abs_ref": float(want.float().abs().max()),
              "launches": counts, "within_tol": err <= TOL, **extra})
        if err > TOL or counts != {n: 1 for n in fb.BLOCK_KERNELS}:
            fail(f"block {i} at the server's shape {tuple(x1.shape)}: max|d| {err} "
                 f"(gate {TOL}), launches {counts}")
    x1 = torch.from_numpy(rng.standard_normal((1, *tail_hw, 112)).astype(np.float32)
                          ).to(dev, torch.bfloat16)
    _build.reset_launches()
    got = fb.fused_tail_chain(x1, blocks, 5, "hardswish", 2)
    counts = dict(_build.LAUNCHES)
    want = fb.tail_chain_plain(x1, blocks, "hardswish", 2)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    emit({"phase": "kernel", "name": "fused_tail_chain", "path": "server",
          "shape": list(x1.shape), "gemm_rows": x1[..., 0].numel(), "max_abs_err": err,
          "max_abs_ref": float(want.float().abs().max()), "launches": counts,
          "ms": cuda_ms(lambda: fb.fused_tail_chain(x1, blocks, 5, "hardswish", 2), 20),
          "plain_ms": cuda_ms(lambda: fb.tail_chain_plain(x1, blocks, "hardswish", 2), 3),
          "within_tol": err <= TOL})
    if err > TOL or counts != {n: 3 for n in fb.BLOCK_KERNELS}:
        fail(f"tail chain at the server's shape {tuple(x1.shape)}: max|d| {err} "
             f"(gate {TOL}), launches {counts}")
    sh, sw = SERVER_HW
    s1 = torch.from_numpy(rng.standard_normal((1, sh // 8, sw // 8)).astype(np.float32)).to(dev)
    _build.reset_launches()
    got = dec.fused_mask_decode(s1, sh, sw)
    counts = dict(_build.LAUNCHES)
    want = dec.fused_mask_decode_plain(s1, sh, sw)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    emit({"phase": "kernel", "name": "fused_mask_decode", "path": "server",
          "shape": list(s1.shape), "out": list(got.shape), "exact": mismatches == 0,
          "foreground_fraction": float(got.float().mean()), "launches": counts,
          "ms": cuda_ms(lambda: dec.fused_mask_decode(s1, sh, sw), 50),
          "plain_ms": cuda_ms(lambda: dec.fused_mask_decode_plain(s1, sh, sw), 10)})
    if mismatches or tuple(got.shape) != (1, sh, sw) or counts != {"fused_mask_decode": 1}:
        fail(f"fused_mask_decode at the server's shape: {mismatches} pixels differ from "
             f"its plain version, out {tuple(got.shape)}, launches {counts}")

    # free the tail-chain tensors before the large elementwise cases
    del x, x1, s1, got, want, d, xc, blocks, mods, model, sblocks
    torch.cuda.empty_cache()
    rows["stencil_floor"] = phase_stencil_kernel(torch)
    rows.update(phase_io_kernels(torch, weights, rng))
    return rows


def stencil_tool():
    """tools/stencil_floor_torch.py as a module, loaded from its path."""
    import importlib.util

    name = "stencil_floor_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def phase_stencil_kernel(torch):
    """stencil_floor in its three modes at the tool's shape and at a ragged
    shape against its plain version, with each mode's time and bound (the
    bound with the products at the float32 rate beside it, as before the
    packed products); the launch plan's shared memory against the kernel's
    own count; the kernels line reports ``full``, the real stencil, beside
    the one stock composition of it."""
    import numpy as np
    import torch.nn.functional as F

    from mtg_card_image_segmentation_tpu_torch.ops.kernels import stencil_floor as sf

    tool = stencil_tool()
    x, w_exp, w_dw = tool.make_inputs(SEED, "cuda")
    k, dil, cexp = tool.K, tool.DIL, tool.CEXP

    def gate(x, w_exp, w_dw, mode, k, dil, what):
        got = sf.stencil_floor(x, w_exp, w_dw, mode, k, dil)
        want = sf.stencil_floor_plain(x, w_exp, w_dw, mode, k, dil)
        torch.cuda.synchronize()
        d = (got - want).abs()
        err, mean_err = float(d.max()), float(d.mean())
        if tuple(got.shape) != (*x.shape[:3], 1) or got.dtype != torch.float32:
            fail(f"stencil_floor[{mode}] {what}: output {got.dtype} {tuple(got.shape)}")
        if err > STENCIL_TOL[0] or mean_err > STENCIL_TOL[1]:
            fail(f"stencil_floor[{mode}] {what}: max|d| {err}, mean|d| {mean_err} above "
                 f"{STENCIL_TOL}")
        return {"max_abs_err": err, "mean_abs_err": mean_err,
                "max_abs_ref": float(want.abs().max())}

    plans = {}
    for name, (shape, e, kk, d) in (("tool", ((tool.B, tool.H, tool.W, tool.CIN), cexp, k, dil)),
                                    ("ragged", STENCIL_RAGGED)):
        plan = sf.stencil_plan(shape, e, kk, d)
        own = sf.kernel_smem_bytes(shape[1], shape[2], shape[3], kk)
        if own != plan["smem_bytes"]:
            fail(f"stencil_floor plan at {shape}: {plan['smem_bytes']} bytes of shared memory, "
                 f"the kernel lays out {own}")
        plans[name] = {key: plan[key] for key in ("ctas", "threads", "slices", "chunks",
                                                   "smem_bytes", "strips", "tasks")}
    per_mode = {}
    for mode in sf.MODES:
        bnd, by = sf.bound_ms(tuple(x.shape), cexp, mode, k)  # the same H100 peaks
        per_mode[mode] = {
            **gate(x, w_exp, w_dw, mode, k, dil, "tool shape"),
            "ms": cuda_ms(lambda: sf.stencil_floor(x, w_exp, w_dw, mode, k, dil), 20),
            "plain_ms": cuda_ms(lambda: sf.stencil_floor_plain(x, w_exp, w_dw, mode, k, dil),
                                2, 1),
            "bound_ms": bnd, "bound_by": by,
            "bound_fp32_ms": sf.bound_ms(tuple(x.shape), cexp, mode, k,
                                         packed_products=False)[0]}
    shape, e, rk, rd = STENCIL_RAGGED
    rng = np.random.default_rng(SEED)
    rx = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", torch.bfloat16)
    rw = torch.from_numpy((rng.standard_normal((shape[-1], e)) * 0.05).astype(np.float32)).cuda()
    rdw = torch.from_numpy((rng.standard_normal((rk * rk, e)) * 0.05).astype(np.float32)).cuda()
    ragged = {mode: gate(rx, rw, rdw, mode, rk, rd, f"ragged {shape} E={e}")
              for mode in sf.MODES}
    w_bf = w_exp.to(torch.bfloat16)
    taps = w_dw.to(torch.bfloat16).reshape(k, k, cexp).permute(2, 0, 1)[:, None].contiguous()

    def library():  # cuBLAS product, cuDNN dilated depthwise, mean
        y = (x @ w_bf).permute(0, 3, 1, 2)
        z = F.conv2d(y, taps, padding=(k - 1) // 2 * dil, dilation=dil, groups=cexp)
        return z.float().mean(dim=1)

    want = sf.stencil_floor_plain(x, w_exp, w_dw, "full", k, dil)
    lib_err = float((library()[..., None] - want).abs().max())
    full = per_mode["full"]
    row = {"ms": full["ms"], "plain_ms": full["plain_ms"], "library_ms": cuda_ms(library, 10),
           "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
           "max_abs_err": max(m["max_abs_err"] for m in [*per_mode.values(),
                                                         *ragged.values()])}
    emit({"phase": "kernel", "name": "stencil_floor", "shape": list(x.shape),
          "expanded": cexp, "k": k, "dilation": dil, "modes": per_mode,
          "ragged": {"shape": list(shape), "expanded": e, "k": rk, "dilation": rd,
                     "modes": ragged},
          "plan": plans, "prev_ms_pr3_recorded": PREV_MS["stencil_floor"],
          "full_minus_pass_ms": full["ms"] - per_mode["pass"]["ms"],
          "arith_minus_pass_ms": per_mode["arith"]["ms"] - per_mode["pass"]["ms"],
          "library_max_abs_err": lib_err, "tolerance": list(STENCIL_TOL), **row})
    return row


def phase_io_kernels(torch, weights, rng):
    """fused_normalize, fused_stem, fused_head_decode and upsample2x_add
    against their plain versions at main-path shapes, each beside its bound
    and the one stock-PyTorch composition of the same function."""
    import numpy as np
    import torch.nn.functional as F

    from mtg_card_image_segmentation_tpu_torch.models.layers import nchw, nhwc
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
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
    # the server's shape: one 480x640 image per /api/corners request
    one = imgs[:1].contiguous()
    for dt in (torch.float32, bf16):
        _build.reset_launches()
        got = pre.fused_normalize(one, dt)
        counts = dict(_build.LAUNCHES)
        want = pre.fused_normalize_plain(one, dt)
        torch.cuda.synchronize()
        if got.dtype != dt or not torch.equal(got, want) or counts != {"fused_normalize": 1}:
            fail(f"fused_normalize ({dt}) at the server's shape {tuple(one.shape)}: "
                 f"{int((got != want).sum())} values differ, launches {counts}")
    emit({"phase": "kernel", "name": "fused_normalize", "path": "server",
          "shape": list(one.shape), "out": "bfloat16 (timed) and float32", "exact": True,
          "launches": counts, "ms": cuda_ms(lambda: pre.fused_normalize(one, bf16), 50),
          "plain_ms": cuda_ms(lambda: pre.fused_normalize_plain(one, bf16), 10)})
    del imgs, one, got, want
    torch.cuda.empty_cache()

    # -- fused_stem: (128, 512, 512, 3) with the predictor's folded weights --
    # The kernel sums its 27 products on the tensor cores, in another order
    # than the plain version's (ky, kx, c): a bf16 output whose float32 sum
    # lies within float32 rounding of a tie rounds the other way. Gate: one
    # bf16 ulp at the output's largest magnitude, mean|d| < 0.01.
    pred = SegPredictor(*weights, SIZE, SIZE, fused_stem=True)
    ops = pred._stem

    def stem_case(imgs, out_dtype=bf16):
        _build.reset_launches()
        got = stem_k.apply_stem(imgs, ops, out_dtype)
        counts = dict(_build.LAUNCHES)
        want = stem_k.apply_stem_plain(imgs, ops, out_dtype)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        ref_max = float(want.float().abs().max())
        # float32 out: the two sums' rounding, at most a few float32 ulps of
        # the largest partial sum
        tol = bf16_ulp(ref_max) if out_dtype == bf16 else 2.0 ** -20 * ref_max
        rec = {"shape": list(imgs.shape), "out": str(out_dtype).split(".")[-1],
               "max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
               "differing_values": int((d > 0).sum()), "max_abs_ref": ref_max, "tol": tol,
               "launches": counts}
        if tuple(got.shape) != (imgs.shape[0], imgs.shape[1] // 2, imgs.shape[2] // 2, 16) \
                or got.dtype != out_dtype or counts != {"fused_stem": 1} \
                or rec["max_abs_err"] > tol or rec["mean_abs_err"] >= 0.01:
            fail(f"fused_stem against its plain version: {rec}")
        return got, rec

    imgs = torch.from_numpy(rng.integers(0, 256, (b, SIZE, SIZE, 3), np.uint8)).to(dev)
    got, main_rec = stem_case(imgs)
    # each image's result does not depend on the batch or on which CTA made
    # it: the kernel on 1- and 2-image slices, bit for bit
    parts = torch.cat([stem_k.apply_stem(imgs[i:j].contiguous(), ops)
                       for i, j in ((0, 1), (1, 3), (3, 4), (b - 2, b))])
    if not torch.equal(parts, torch.cat([got[:4], got[b - 2:]])):
        fail("fused_stem: the kernel on 1- and 2-image slices differs from the b128 run")
    cases = []
    for shape, dt in (((b, *SERVER_HW), bf16), ((1, *SERVER_HW), bf16), ((2, 40, 24), bf16),
                      ((2, 40, 24), torch.float32)):
        small = torch.from_numpy(rng.integers(0, 256, (*shape, 3), np.uint8)).to(dev)
        cases.append(stem_case(small, dt)[1])
        del small
    stem_mod = pred.model.backbone.stem

    def stem_library():  # center, cuDNN conv, bias, hardswish
        with torch.no_grad():
            return stem_mod((imgs.float() - pred._center).to(bf16))

    lib_err = float((stem_library().float() - got.float()).abs().max())
    ho = SIZE // 2
    # the 27 products per output value on the tensor cores, bias and
    # hardswish (5 fp32 operations) per output value on the CUDA cores
    bnd, by = bound(imgs.numel() + b * ho * ho * 16 * 2 + 16 * 16 * 4 + 16 * 4 + 3 * 4,
                    tensor_flops=b * ho * ho * 16 * 2 * 27, fp32_flops=b * ho * ho * 16 * 5)
    ms, count = timed_launches("fused_stem", lambda: stem_k.apply_stem(imgs, ops, bf16), 20)
    rows["fused_stem"] = {
        "ms": ms,
        "plain_ms": cuda_ms(lambda: stem_k.apply_stem_plain(imgs, ops, bf16), 2, 1),
        "library_ms": cuda_ms(stem_library, 10), "bound_ms": bnd, "bound_by": by,
        "max_abs_err": main_rec["max_abs_err"]}
    emit({"phase": "kernel", "name": "fused_stem", "shape": list(imgs.shape),
          "out": list(got.shape), "mean_abs_err": main_rec["mean_abs_err"],
          "differing_values": main_rec["differing_values"], "max_abs_ref": main_rec["max_abs_ref"],
          "one_bf16_ulp": main_rec["tol"], "library_max_abs_err": lib_err,
          "batch_split_exact": True, "cases": cases, "launches": count,
          "prev_ms_pr4_recorded": PREV_MS_PR4["fused_stem"], **rows["fused_stem"]})
    del got, parts
    torch.cuda.empty_cache()

    # -- fused_head_decode at b128 with the predictor's real x, gw, low ------
    def head_features(p, images):
        """The head decode's inputs as predictor ``p`` makes them."""
        x = (images.float() - p._center).to(bf16)
        taps = seg._fused_backbone(p.model.backbone, x, p._tail)
        feats, gw, w_lo, bias_d = seg._head_gated(p.model.head, taps["high"], p._head_vectors)
        return feats.contiguous(), gw, taps["low"].contiguous(), w_lo, bias_d

    def head_case(feats, gw, low, w_lo, bias_d, out_h, out_w, what):
        """The kernel against its plain version, bit for bit, one launch."""
        _build.reset_launches()
        got = dec.fused_head_decode(feats, gw, low, w_lo, bias_d, out_h, out_w)
        counts = dict(_build.LAUNCHES)
        want = dec.fused_head_decode_plain(feats, gw, low, w_lo, bias_d, out_h, out_w)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        if mismatches or counts != {"fused_head_decode": 1} \
                or tuple(got.shape) != (feats.shape[0], out_h, out_w):
            fail(f"fused_head_decode {what}: {mismatches} pixels differ from its plain "
                 f"version, launches {counts}, shape {tuple(got.shape)}")
        return got, {"what": what, "x": list(feats.shape), "low": list(low.shape),
                     "out": [out_h, out_w], "differing_pixels": mismatches,
                     "max_abs_err": float((got.float() - want.float()).abs().max()),
                     "foreground_fraction": float(got.float().mean()), "launches": counts}

    with torch.inference_mode():
        feats, gw, low, w_lo, bias_d = head_features(pred, imgs)
        got, main_rec = head_case(feats, gw, low, w_lo, bias_d, SIZE, SIZE, "b128 512x512")
        cases = []
        # the server's size from its own predictor's features, b128 and b1
        pred320 = SegPredictor(*weights, *SERVER_HW)
        f320 = head_features(pred320, imgs[:, :SERVER_HW[0], :SERVER_HW[1]].contiguous())
        cases.append(head_case(*f320, *SERVER_HW, "b128 320x240")[1])
        cases.append(head_case(*(t[:1].contiguous() if t.dim() > 1 else t for t in f320[:3]),
                               f320[3], f320[4], *SERVER_HW, "b1 320x240")[1])
        del f320, pred320
        # a ragged case: bands that end inside the image, 8-column groups
        small = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                 for s in ((2, 10, 8, 24), (2, 24), (2, 20, 16, 16), (16,))]
        cases.append(head_case(small[0].to(bf16), small[1], small[2].to(bf16), small[3],
                               torch.tensor(0.17, device=dev), 160, 128, "ragged 160x128")[1])
        # a mask that only the plain version's summation order leaves empty
        tree = head_case(*dec.tree_order_case(dev), "tree order 160x128")
        if int(tree[0].sum()):
            fail("fused_head_decode: the tree-order case's mask is not empty")
        cases.append(tree[1])

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
        plan = dec.head_decode_plan(b, h16, h16, c, h8, h8, cl, SIZE, SIZE,
                                    _build.sm_count(dev))
        ms, count = timed_launches(
            "fused_head_decode",
            lambda: dec.fused_head_decode(feats, gw, low, w_lo, bias_d, SIZE, SIZE), 20)
        rows["fused_head_decode"] = {
            "ms": ms,
            "plain_ms": cuda_ms(lambda: dec.fused_head_decode_plain(
                feats, gw, low, w_lo, bias_d, SIZE, SIZE), 3, 1),
            "library_ms": cuda_ms(head_library, 10), "bound_ms": bnd, "bound_by": by,
            "max_abs_err": main_rec["max_abs_err"]}
    emit({"phase": "kernel", "name": "fused_head_decode", "x": list(feats.shape),
          "low": list(low.shape), "out": list(got.shape), "exact": True,
          "foreground_fraction": float(got.float().mean()),
          "agreement_with_library": lib_agree, "cases": cases,
          "plan": {k: v for k, v in plan.items() if k != "bands"}, "launches": count,
          "prev_ms_pr4_recorded": PREV_MS_PR4["fused_head_decode"],
          **rows["fused_head_decode"]})
    del imgs, feats, low, got, pred
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


def _time_predict(torch, pred, imgs, calls: int = 5):
    """(ms per call, peak bytes, launch counts of ONE further call) of
    ``pred.predict(imgs)``: host clock around ``calls`` calls that end in a
    synchronize, after one warm-up call."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

    pred.predict(imgs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(calls):
        pred.predict(imgs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    peak = torch.cuda.max_memory_allocated()
    _build.reset_launches()
    pred.predict(imgs)
    torch.cuda.synchronize()
    return ms, peak, dict(_build.LAUNCHES)


def _check_seg_launches(name: str, counts: dict) -> None:
    """One ``predict`` of the default kernel path: 3 tail blocks x 4 block
    kernels and one mask decode."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import BLOCK_KERNELS

    want = {n: 3 for n in BLOCK_KERNELS}
    want["fused_mask_decode"] = 1
    if counts != want:
        fail(f"{name}: launches per predict {counts}, want {want}")


def phase_seg_modes(torch, weights, base, imgs, card):
    """The serving modes at 512x512 b128 on the card: int8 weights against
    the bf16 predictor ``base``; slim widths on the kernel path against the
    masked dense model on the kernel path and against their own stock-op
    path."""
    from mtg_card_image_segmentation_tpu_torch.compression.slim import (
        expansion_channel_prune,
        param_count,
        slim_seg_state,
        tree_map,
    )
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

    params, stats = weights
    base_masks = base.predict(imgs)
    base_ms, base_peak, _ = _time_predict(torch, base, imgs)

    q = SegPredictor(params, stats, SIZE, SIZE, quantize="int8")
    leaves = []
    tree_map(leaves.append, q._qparams)
    int8_bytes = sum(t.numel() for t in leaves if t.dtype == torch.int8)
    if not int8_bytes or any(t.device.type != "cuda" for t in leaves):
        fail("int8 predictor holds no int8 kernels on the card")
    ms, peak, counts = _time_predict(torch, q, imgs)
    _check_seg_launches("int8", counts)
    agree = float((q.predict(imgs) == base_masks).float().mean())
    emit({"phase": "seg_modes", "mode": "int8", "batch": imgs.shape[0], "size": SIZE,
          "ms_per_batch": ms, "bf16_ms_per_batch": base_ms, "peak_mem_bytes": peak,
          "bf16_peak_mem_bytes": base_peak, "int8_kernel_bytes": int8_bytes,
          "launches_per_predict": counts, "agreement_vs_bf16": agree,
          "agreement_floor": 0.99, "meets_0.999": agree >= 0.999,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if agree < 0.99:
        fail(f"int8 vs bf16 agreement {agree} < 0.99")
    del q

    pruned, _ = expansion_channel_prune(params, 0.3)
    sp, ss, overrides = slim_seg_state(pruned, stats)
    slim_pred = SegPredictor(sp, ss, SIZE, SIZE)
    masked = SegPredictor(pruned, stats, SIZE, SIZE)
    slim_ref = SegPredictor(sp, ss, SIZE, SIZE, use_kernels=False)
    ms, peak, counts = _time_predict(torch, slim_pred, imgs)
    _check_seg_launches("slim", counts)
    masked_ms, _, _ = _time_predict(torch, masked, imgs)
    ref_ms, _, _ = _time_predict(torch, slim_ref, imgs)
    slim_masks = slim_pred.predict(imgs)
    vs_masked = float((slim_masks == masked.predict(imgs)).float().mean())
    vs_ref = float((slim_masks == slim_ref.predict(imgs)).float().mean())
    emit({"phase": "seg_modes", "mode": "slim", "amount": 0.3, "batch": imgs.shape[0],
          "size": SIZE, "tail_widths": list(overrides[12:]),
          "params": param_count(sp), "dense_params": param_count(params),
          "ms_per_batch": ms, "masked_dense_ms_per_batch": masked_ms,
          "use_kernels_false_ms_per_batch": ref_ms, "peak_mem_bytes": peak,
          "launches_per_predict": counts, "agreement_vs_masked_dense": vs_masked,
          "agreement_vs_use_kernels_false": vs_ref,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if vs_masked < 0.999:
        fail(f"slim vs masked dense on the kernel path {vs_masked} < 0.999")
    if vs_ref < 0.99:
        fail(f"slim kernel path vs its use_kernels=False {vs_ref} < 0.99")


FUSED_320_BLOCKS = (1, 6, 13)  # blocks also held alone at 320x240 b32 (odd widths from 6 on)
FUSED_320_B = 32


def _block_want(pred) -> dict:
    """Exact launches of one ``predict`` of a per-block kernel path: K1 for
    each kernel block with an expand conv, K2 and K4 for each, K3 for each
    with SE, and one mask decode."""
    blocks = [pred.model.backbone.block(i) for i in pred.kernel_blocks]
    want = {"expand_gemm": sum(b.expand is not None for b in blocks),
            "depthwise": len(blocks), "se_gate": sum(b.se is not None for b in blocks),
            "project_gemm": len(blocks), "fused_mask_decode": 1}
    return {n: c for n, c in want.items() if c}


def _one_predict_launches(torch, pred, imgs) -> tuple:
    """(masks, launch counts) of one ``predict``, the counts zeroed just
    before it and read just after."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

    _build.reset_launches()
    masks = pred.predict(imgs)
    torch.cuda.synchronize()
    return masks, dict(_build.LAUNCHES)


def block_steps(torch, fb, x, bw, stride: int, act: str, res: bool, dil: int,
                iters: int = 10) -> dict:
    """A block's K1-K4 timed one at a time (CUDA events) on the inputs the
    block gives them, and the depthwise's band count."""
    b, h, w, _ = x.shape
    steps, y = {}, x
    if bw.exp_w is not None:
        y = torch.empty((b, h, w, bw.cexp), dtype=torch.bfloat16, device=x.device)
        steps["expand_gemm"] = cuda_ms(lambda: fb._gemm(
            x, bw.exp_w, bw.exp_b, None, 0, None, y, act, "expand_gemm"), iters)
    dw, sums, nbands = fb._depthwise(y, bw, stride, act, dil)
    steps["depthwise"] = cuda_ms(lambda: fb._depthwise(y, bw, stride, act, dil), iters)
    npix = dw.shape[1] * dw.shape[2]
    gate = None
    if sums is not None:
        gate = fb._se_gate(sums, nbands, npix, bw)
        steps["se_gate"] = cuda_ms(lambda: fb._se_gate(sums, nbands, npix, bw), iters)
    out = torch.empty((*dw.shape[:3], bw.cout), dtype=torch.bfloat16, device=x.device)
    steps["project_gemm"] = cuda_ms(lambda: fb._gemm(
        dw, bw.proj_w, bw.proj_b, gate, npix, x if res else None, out, None,
        "project_gemm"), iters)
    return {"steps_ms": steps, "depthwise_bands": nbands}


def block_case_row(torch, blk, x, iters: int = 10) -> dict:
    """One folded block on the card at ``x``'s shape: the per-block kernel
    against its plain version (``TOL``), its launches, its ms beside the
    stock module's (cuDNN) on the same input and beside its bound (in + out
    + weight bytes over the HBM rate, or its operations: the 1x1 GEMMs on
    the tensor cores, the depthwise and SE in fp32)."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import fused_block as fb

    bw = fb.BlockWeights.from_module(blk)
    args = (blk.kernel, blk.stride, blk.act, blk.residual, blk.dilation)
    k, st, act, res, dil = args
    _build.reset_launches()
    got = fb.fused_inverted_residual(x, bw, *args)
    counts = dict(_build.LAUNCHES)
    want = fb.inverted_residual_plain(x, bw, st, act, res, dil, torch.bfloat16)
    module = blk(x)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    row = {"shape": list(x.shape), "out": list(got.shape), "k": k, "stride": st,
           "dilation": dil, "act": act, "expand": bw.exp_w is not None,
           "se": bw.se1_w is not None, "residual": res, "max_abs_err": err,
           "max_abs_ref": float(want.float().abs().max()),
           "module_max_abs_diff": float((module.float() - want.float()).abs().max()),
           "within_tol": err <= TOL, "launches": counts,
           "launches_want": {n: 1 for n, on in zip(fb.BLOCK_KERNELS, (
               bw.exp_w is not None, True, bw.se1_w is not None, True)) if on}}
    del got, want, module
    b, h, w, _ = x.shape
    _, oh, ow, _ = row["out"]
    m_in, m_out = b * h * w, b * oh * ow
    wbytes = sum(t.numel() * t.element_size() for t in
                 (bw.exp_w, bw.exp_b, bw.dw_w, bw.dw_b, bw.se1_w, bw.se1_b,
                  bw.se2_w, bw.se2_b, bw.proj_w, bw.proj_b) if t is not None)
    tflops = 2 * m_out * bw.cexp * bw.cout + (
        2 * m_in * bw.cin * bw.cexp if bw.exp_w is not None else 0)
    fflops = 2 * m_out * k * k * bw.cexp + (
        4 * b * bw.cexp * bw.se1_w.shape[1] if bw.se1_w is not None else 0)
    bnd, by = bound((m_in * bw.cin + m_out * bw.cout) * 2 + wbytes,
                    tensor_flops=tflops, fp32_flops=fflops)
    row["cuda_ms"] = cuda_ms(lambda: fb.fused_inverted_residual(x, bw, *args), iters)
    row["module_ms"] = cuda_ms(lambda: blk(x), iters)
    row.update({"bound_ms": bnd, "bound_by": by, "share": bnd / row["cuda_ms"],
                "kernel_over_module": row["cuda_ms"] / row["module_ms"]})
    row.update(block_steps(torch, fb, x, bw, st, act, res, dil, iters))
    return row


def phase_seg_fused_blocks(torch, weights, default, imgs, card) -> dict:
    """The per-block kernel on every backbone block and the predictor's
    ``fused_blocks``/``fused_chain`` options, on the card:

    - each block 0-14 alone at its 512x512 b128 input (the stock backbone's
      activations from ``imgs``), and blocks 1, 6, 13 at 320x240 b32:
      ``block_case_row``;
    - ``SegPredictor(fused_blocks=range(15))`` at 512x512 b128: ms/batch
      beside the default path's (in alternating turns), peak memory, the
      exact launches of one ``predict``, masks against the same option's
      CPU path on 4 images (0.999), against the default path and the
      float32 stock-op path on the card (0.99: bf16 rounded at other
      points);
    - the same at 320x240 b32, against the CPU path;
    - ``fused_chain=False`` with the default blocks: 3 x 4 per-block
      launches, no call of the tail chain, masks against the chain's.

    Returns each predictor run's block-kernel launches (one ``predict``
    each), by path."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.models.mobilenetv3 import (
        MOBILENET_V3_LARGE_ROWS,
    )
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import BLOCK_KERNELS
    from mtg_card_image_segmentation_tpu_torch.serving import predictor as seg
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

    t_start = time.perf_counter()
    bad, by_path = [], {}
    all_ids = tuple(range(len(MOBILENET_V3_LARGE_ROWS)))
    tags = {"card": card["name"], "nvidia_smi": card["nvidia_smi"]}

    def blocks_alone(pred, images, ids, size):
        bb = pred.model.backbone
        with torch.inference_mode():
            x = bb.stem((images.float() - pred._center).to(pred.dtype))
            for i in range(max(ids) + 1):
                blk = bb.block(i)
                if i in ids:
                    row = block_case_row(torch, blk, x.contiguous())
                    emit({"phase": "seg_fused_blocks", "part": "block", "block": i,
                          "size": size, **row, **tags})
                    if not row["within_tol"] or row["launches"] != row["launches_want"]:
                        bad.append(f"block {i} at {row['shape']}: max|d| {row['max_abs_err']} "
                                   f"(gate {TOL}), launches {row['launches']}")
                x = blk(x)
        del x
        torch.cuda.empty_cache()

    blocks_alone(default, imgs, all_ids, [SIZE, SIZE])

    # fused_blocks=range(15) and fused_chain=False at 512x512 b128, timed in
    # turns with the default (and blocks 1-14, block 0 left to its module)
    allp = SegPredictor(*weights, SIZE, SIZE, fused_blocks=all_ids)
    nochain = SegPredictor(*weights, SIZE, SIZE, fused_chain=False)
    if allp.kernel_blocks != all_ids:
        bad.append(f"kernel_blocks {allp.kernel_blocks}, want {all_ids}")
    preds = {"default": default, "all_blocks": allp, "fused_chain_off": nochain,
             "blocks_1_14": SegPredictor(*weights, SIZE, SIZE, fused_blocks=all_ids[1:])}
    calls, rounds = 5, 2
    ms = {name: [] for name in preds}
    for r in range(rounds):
        for name in (list(preds) if r % 2 == 0 else list(preds)[::-1]):
            pred = preds[name]
            pred.predict(imgs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                pred.predict(imgs)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / calls)
    peak = {}
    for name, pred in preds.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pred.predict(imgs)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated()
    masks, counts = _one_predict_launches(torch, allp, imgs)
    by_path["seg_fused_blocks_b128"] = sum(counts.get(n, 0) for n in BLOCK_KERNELS)
    want = _block_want(allp)
    base = default.predict(imgs)
    agree = float((masks == base).float().mean())
    cpu = SegPredictor(*weights, SIZE, SIZE, device="cpu", fused_blocks=all_ids)
    t0 = time.perf_counter()
    agree_cpu = allp.mask_agreement(cpu, imgs[:4])
    cpu_s = time.perf_counter() - t0
    del cpu
    # which of the two bf16 paths lies nearer the float32 stock-op path
    fp32 = SegPredictor(*weights, SIZE, SIZE, use_kernels=False, dtype=torch.float32)
    fp32_masks = fp32.predict(imgs)
    agree_fp32 = float((masks == fp32_masks).float().mean())
    default_fp32 = float((base == fp32_masks).float().mean())
    del fp32, fp32_masks
    emit({"phase": "seg_fused_blocks", "part": "predict", "variant": "all_blocks",
          "batch": imgs.shape[0], "size": SIZE, "kernel_blocks": list(allp.kernel_blocks),
          "calls": calls, "ms_per_batch_rounds": ms["all_blocks"],
          "ms_per_batch": min(ms["all_blocks"]),
          "default_ms_per_batch_rounds": ms["default"],
          "default_ms_per_batch": min(ms["default"]),
          "blocks_1_14_ms_per_batch_rounds": ms["blocks_1_14"],
          "blocks_1_14_ms_per_batch": min(ms["blocks_1_14"]),
          "blocks_1_14_peak_mem_bytes": peak["blocks_1_14"], "peak_mem_bytes": peak["all_blocks"],
          "default_peak_mem_bytes": peak["default"], "launches_per_predict": counts,
          "launches_want": want, "agreement_vs_cpu": agree_cpu, "cpu_images": 4,
          "cpu_seconds": cpu_s, "agreement_vs_default": agree,
          "agreement_vs_default_floor": 0.99, "agreement_vs_fp32_stock": agree_fp32,
          "default_agreement_vs_fp32_stock": default_fp32, **tags})
    if counts != want:
        bad.append(f"fused_blocks=all launches per predict {counts}, want {want}")
    if masks.dtype != torch.uint8 or tuple(masks.shape) != tuple(base.shape):
        bad.append(f"fused_blocks=all masks {masks.dtype} {tuple(masks.shape)}")
    # the kernels are held by the CPU path of the same option (their plain
    # versions, 0.999); against the default path, which rounds bf16 at other
    # points (after each stock conv and bias add, not once per block), and
    # against the float32 stock-op path, by the floor of such pairs (0.99).
    # That floor rests on the reference's own gap: in
    # tests/test_torch_seg_fused_blocks.py (bf16, Pallas in interpret mode)
    # the JAX package's range(15)-vs-default pair reads 0.99874 at 512x512 b2
    # (0.99933 at 128x128), the port's 0.99864 (0.99902), and the port's
    # range(15) masks agree with the JAX package's at 0.99960 at 128x128
    if not agree_cpu >= 0.999:
        bad.append(f"fused_blocks=all agreement vs CPU {agree_cpu} < 0.999")
    if not agree >= 0.99 or not agree_fp32 >= 0.99:
        bad.append(f"fused_blocks=all agreement vs default {agree}, vs the float32 stock-op "
                   f"path {agree_fp32} (floor 0.99)")
    del masks
    torch.cuda.empty_cache()

    # fused_chain=False, default blocks: block by block, never the chain
    chain_calls = []
    chain = seg.fused_tail_chain

    def counted_chain(*a, **kw):
        chain_calls.append(1)
        return chain(*a, **kw)

    seg.fused_tail_chain = counted_chain
    try:
        masks, counts = _one_predict_launches(torch, nochain, imgs)
        nochain_chain_calls = len(chain_calls)
        default.predict(imgs)
        default_chain_calls = len(chain_calls) - nochain_chain_calls
    finally:
        seg.fused_tail_chain = chain
    by_path["seg_fused_chain_off"] = sum(counts.get(n, 0) for n in BLOCK_KERNELS)
    want = _block_want(nochain)
    agree = float((masks == base).float().mean())
    emit({"phase": "seg_fused_blocks", "part": "predict", "variant": "fused_chain_off",
          "batch": imgs.shape[0], "size": SIZE, "kernel_blocks": list(nochain.kernel_blocks),
          "ms_per_batch_rounds": ms["fused_chain_off"], "ms_per_batch": min(ms["fused_chain_off"]),
          "peak_mem_bytes": peak["fused_chain_off"], "launches_per_predict": counts,
          "launches_want": want, "chain_calls": nochain_chain_calls,
          "default_chain_calls": default_chain_calls,
          "agreement_vs_chain": agree, **tags})
    if counts != want or nochain_chain_calls != 0 or default_chain_calls != 1:
        bad.append(f"fused_chain=False launches {counts} (want {want}), chain calls "
                   f"{nochain_chain_calls} (default path: {default_chain_calls})")
    if not agree >= 0.999:
        bad.append(f"fused_chain=False agreement vs the chain {agree} < 0.999")
    del allp, nochain, preds, masks, base
    torch.cuda.empty_cache()

    # 320x240 b32: blocks 1, 6, 13 alone, and the predictor against the CPU
    h, w = SERVER_HW
    p320 = SegPredictor(*weights, h, w, fused_blocks=all_ids)
    imgs320 = torch.from_numpy(np.random.default_rng(SEED + 321).integers(
        0, 256, (FUSED_320_B, h, w, 3), np.uint8)).cuda()
    blocks_alone(p320, imgs320, FUSED_320_BLOCKS, [h, w])
    ms320, peak320, _ = _time_predict(torch, p320, imgs320)
    masks, counts = _one_predict_launches(torch, p320, imgs320)
    by_path["seg_fused_blocks_320x240"] = sum(counts.get(n, 0) for n in BLOCK_KERNELS)
    want = _block_want(p320)
    cpu = SegPredictor(*weights, h, w, device="cpu", fused_blocks=all_ids)
    agree_cpu = p320.mask_agreement(cpu, imgs320[:4])
    emit({"phase": "seg_fused_blocks", "part": "predict", "variant": "all_blocks",
          "batch": FUSED_320_B, "size": [h, w], "ms_per_batch": ms320,
          "peak_mem_bytes": peak320, "launches_per_predict": counts, "launches_want": want,
          "foreground_fraction": float(masks.float().mean()),
          "agreement_vs_cpu": agree_cpu, "cpu_images": 4, **tags})
    if counts != want or tuple(masks.shape) != (FUSED_320_B, h, w):
        bad.append(f"fused_blocks=all at 320x240: launches {counts} (want {want}), "
                   f"masks {tuple(masks.shape)}")
    if not agree_cpu >= 0.999:
        bad.append(f"fused_blocks=all at 320x240 agreement vs CPU {agree_cpu} < 0.999")
    emit({"phase": "seg_fused_blocks", "part": "done", "launches_by_path": by_path,
          "seconds": time.perf_counter() - t_start})
    if bad:
        fail(f"seg_fused_blocks: {bad}")
    return by_path


def phase_seg_320x240(torch, weights, card):
    """SegPredictor.predict at the server's default 320x240, b128, against
    the port's CPU path on 4 images."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

    h, w = SERVER_HW
    b = BATCHES[-1]
    pred = SegPredictor(*weights, h, w)
    imgs = np.random.default_rng(SEED + 320).integers(0, 256, (b, h, w, 3), np.uint8)
    dev_imgs = torch.from_numpy(imgs).cuda()
    ms, peak, counts = _time_predict(torch, pred, dev_imgs)
    _check_seg_launches("seg_320x240", counts)
    masks = pred.predict(dev_imgs)
    if masks.dtype != torch.uint8 or tuple(masks.shape) != (b, h, w) or int(masks.max()) > 1:
        fail(f"320x240 masks {masks.dtype} {tuple(masks.shape)}")
    cpu = SegPredictor(*weights, h, w, device="cpu")
    t0 = time.perf_counter()
    agree = pred.mask_agreement(cpu, imgs[:4])
    emit({"phase": "seg_320x240", "batch": b, "size": [h, w], "ms_per_batch": ms,
          "img_per_s": b * 1e3 / ms, "peak_mem_bytes": peak, "launches_per_predict": counts,
          "foreground_fraction": float(masks.float().mean()),
          "card_vs_cpu_agreement": agree, "card_vs_cpu_images": 4,
          "card_vs_cpu_seconds": time.perf_counter() - t0,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if agree < 0.999:
        fail(f"320x240 card kernel path vs CPU plain path agreement {agree} < 0.999")


def _post(port: int, path: str, body: bytes):
    """(status, parsed JSON, wall ms) of one POST to the local server."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=body, headers={"Content-Length": str(len(body))})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return resp.status, json.loads(data), (time.perf_counter() - t0) * 1e3


def phase_server(torch, weights, pose_weights, yolo_weights, card):
    """The HTTP server on the card, started as a user starts it (checkpoints
    on disk, ``from_checkpoint``, the default sizes), asked over HTTP, every
    answer held against the predictor called directly, and that call (the
    kernel path at one image) against the CPU predictor (the plain path)
    loaded from the same checkpoint."""
    import base64
    import http.client
    import statistics
    import threading

    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import BLOCK_KERNELS
    from mtg_card_image_segmentation_tpu_torch.serving import imagecodec
    from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import (
        PosePredictor,
        YoloCornerPredictor,
    )
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
    from mtg_card_image_segmentation_tpu_torch.serving.server import DemoServer
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import save_params

    rng = np.random.default_rng(SEED + 7)
    # bodies of other sizes than either model's
    images = [rng.integers(0, 256, (360 + 24 * i, 270 + 18 * i, 3), np.uint8) for i in range(8)]
    bodies = [imagecodec.encode_png(im) for im in images]
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        save_params(root, "seg", *weights)
        save_params(root, "pose", *pose_weights)
        save_params(root, "yolo", *yolo_weights)
        t0 = time.perf_counter()
        srv = DemoServer(root, root, port=0, checkpoint=f"{root}/seg",
                         pose_checkpoint=f"{root}/pose", host="127.0.0.1")
        start_s = time.perf_counter() - t0
        srv.start_background()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            health = json.loads(resp.read())
            conn.close()
            if resp.status != 200 or not health.get("tpu_inference") \
                    or health.get("model_hw") != list(SERVER_HW):
                fail(f"/healthz: {resp.status} {health}")
            if srv.predictor.device.type != "cuda" or srv.pose_predictor.device.type != "cuda":
                fail("the server's predictors are not on the card")

            answers = {}
            stop_gc = gc_timer()
            _build.reset_launches()
            for i in range(4):  # one request at a time
                answers[("/api/segment", i)] = _post(srv.port, "/api/segment", bodies[i])
                answers[("/api/corners", i)] = _post(srv.port, "/api/corners", bodies[i])

            def client(path):  # two clients at once, four requests each
                for i in range(4, 8):
                    answers[(path, i)] = _post(srv.port, path, bodies[i])

            threads = [threading.Thread(target=client, args=(p,))
                       for p in ("/api/segment", "/api/corners")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            if any(t.is_alive() for t in threads) or len(answers) != 16:
                fail(f"concurrent clients did not finish: {len(answers)} answers")
            gc_requests = stop_gc()
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            want = {n: 3 * 8 for n in BLOCK_KERNELS}
            want.update({"fused_mask_decode": 8, "fused_normalize": 8})
            if launches != want:
                fail(f"server path launches {launches}, want {want}")

            bad_status, bad, _ = _post(srv.port, "/api/segment", b"not an image")
            if bad_status != 400 or "error" not in bad:
                fail(f"undecodable body answered {bad_status} {bad}")

            # every answer against the predictor called directly, and the
            # direct call (the kernels at the server's one-image shapes)
            # against the port's CPU predictor from the same checkpoint: the
            # plain versions, stock ops only
            codec, sh, sw = srv.codec, *srv.model_hw
            ph, pw = srv.pose_hw
            cpu_seg = SegPredictor.from_checkpoint(root, "seg", sh, sw, device="cpu")
            cpu_pose = PosePredictor.from_checkpoint(root, "pose", ph, pw, device="cpu")
            worst_px, fractions = 0.0, []
            mask_vs_cpu, hm_vs_cpu, decode_vs_cpu = [], [0.0, 0.0], [0.0, 0.0]
            for i, im in enumerate(images):
                status, body, _ = answers[("/api/segment", i)]
                if status != 200 or body.get("shape") != [sh, sw]:
                    fail(f"/api/segment {i}: {status} {body}")
                mask = imagecodec.decode_png(base64.b64decode(body["mask_png_b64"]))[:, :, 0]
                direct = srv.predictor.predict(codec.resize(im, sh, sw)[None])[0].cpu().numpy()
                if mask.shape != (sh, sw) or not np.array_equal(mask, direct * 255):
                    fail(f"/api/segment {i}: mask differs from predict on "
                         f"{int((mask != direct * 255).sum())} pixels")
                if abs(body["card_fraction"] - float(direct.mean())) > 1e-9:
                    fail(f"/api/segment {i}: card_fraction {body['card_fraction']}")
                fractions.append(body["card_fraction"])
                on_cpu = cpu_seg.predict(codec.resize(im, sh, sw)[None])[0].numpy()
                mask_vs_cpu.append(float((direct == on_cpu).mean()))
                if mask_vs_cpu[-1] < 0.999:
                    fail(f"/api/segment {i}: the card's mask agrees with the CPU predictor's "
                         f"on {mask_vs_cpu[-1]} of the pixels, below 0.999")
                status, body, _ = answers[("/api/corners", i)]
                if status != 200 or body.get("image_shape") != list(im.shape[:2]):
                    fail(f"/api/corners {i}: {status} {body}")
                px, conf, valid = srv.pose_predictor.predict_valid(codec.resize(im, ph, pw)[None])
                px = srv.pose_predictor.scale_to_original(px[0].cpu().numpy(), im.shape[:2])
                d = float(np.abs(np.asarray(body["corners"]) - px).max())
                worst_px = max(worst_px, d)
                # the JSON rounds to 0.01 px: 0.005 of rounding + 1e-3
                if d > 6e-3 or body["valid"] != [bool(v) for v in valid[0].cpu()]:
                    fail(f"/api/corners {i}: differs from predict_valid by {d} px")
                # random weights give flat heatmaps, so (as in pose_card_vs_cpu)
                # the heatmaps are held, and the decode apart on equal heatmaps
                resized = codec.resize(im, ph, pw)[None]
                hm_card = srv.pose_predictor.heatmaps(resized)
                dh = (hm_card.cpu() - cpu_pose.heatmaps(resized)).abs()
                hm_vs_cpu = [max(hm_vs_cpu[0], float(dh.max())),
                             max(hm_vs_cpu[1], float(dh.mean()))]
                px_card, conf_card = srv.pose_predictor.decode(hm_card)
                px_cpu, conf_cpu = cpu_pose.decode(hm_card.cpu())
                decode_vs_cpu = [max(decode_vs_cpu[0], float((px_card.cpu() - px_cpu).abs().max())),
                                 max(decode_vs_cpu[1],
                                     float((conf_card.cpu() - conf_cpu).abs().max()))]
                if float(dh.max()) > HEATMAP_TOL[0] or float(dh.mean()) > HEATMAP_TOL[1]:
                    fail(f"/api/corners {i}: card vs CPU heatmaps max|d| {float(dh.max())}, "
                         f"mean|d| {float(dh.mean())} above {HEATMAP_TOL}")
                if decode_vs_cpu[0] > 1e-3 or decode_vs_cpu[1] > 1e-6:
                    fail(f"/api/corners {i}: card vs CPU decode of the same heatmaps "
                         f"{decode_vs_cpu}")
            stats = {}
            for path in ("/api/segment", "/api/corners"):
                serial = [answers[(path, i)] for i in range(4)]
                both = [answers[(path, i)] for i in range(4, 8)]
                inf = [a[1]["inference_ms"] for a in serial + both]
                stats[path] = {
                    "inference_ms_median": statistics.median(inf),
                    "inference_ms_min": min(inf), "inference_ms_max": max(inf),
                    "serial_inference_ms": [a[1]["inference_ms"] for a in serial],
                    "concurrent_inference_ms": [a[1]["inference_ms"] for a in both],
                    "serial_wall_ms_per_request": statistics.mean(a[2] for a in serial),
                    "concurrent_wall_ms_per_request": statistics.mean(a[2] for a in both)}
        finally:
            srv.shutdown()
        emit({"phase": "server", "image_codec": srv.codec.name, "seg_size": list(srv.model_hw),
              "pose_size": list(srv.pose_hw), "pose_family": "hrnet",
              "start_seconds": start_s, "warm_seconds": srv.warm_seconds,
              "requests": 16, "launches": launches, "masks_equal_direct_predict": True,
              "corners_max_abs_err_px": worst_px, "card_fractions": fractions,
              "mask_agreement_card_vs_cpu_min": min(mask_vs_cpu),
              "mask_agreement_card_vs_cpu": mask_vs_cpu,
              "heatmap_card_vs_cpu_max_abs_err": hm_vs_cpu[0],
              "heatmap_card_vs_cpu_mean_abs_err": hm_vs_cpu[1],
              "decode_card_vs_cpu_max_abs_err_px": decode_vs_cpu[0],
              "decode_card_vs_cpu_max_abs_err_conf": decode_vs_cpu[1],
              "bad_body_status": bad_status, "gc_during_requests": gc_requests,
              **{k.rsplit("/", 1)[1]: v for k, v in stats.items()},
              "card": card["name"], "nvidia_smi": card["nvidia_smi"]})

        # the same server with --pose-family yolo (square input, the larger
        # side), and with the zlib codec, so that both codecs run here
        t0 = time.perf_counter()
        srv = DemoServer(root, root, port=0, pose_checkpoint=f"{root}/yolo",
                         pose_family="yolo", host="127.0.0.1",
                         codec=imagecodec.ZlibCodec())
        start_s = time.perf_counter() - t0
        srv.start_background()
        try:
            if srv.pose_hw != (YOLO_SIZE, YOLO_SIZE) or srv.pose_predictor.device.type != "cuda":
                fail(f"yolo server: size {srv.pose_hw}, device {srv.pose_predictor.device}")
            worst_px, inf, lv_vs_cpu = 0.0, [], [0.0, 0.0]
            cpu_yolo = YoloCornerPredictor.from_checkpoint(root, "yolo", imgsz=YOLO_SIZE,
                                                           device="cpu")
            for i in range(4):
                status, body, _ = _post(srv.port, "/api/corners", bodies[i])
                if status != 200 or len(body.get("corners", [])) != 4:
                    fail(f"yolo /api/corners {i}: {status} {body}")
                im = images[i]
                px, conf, valid = srv.pose_predictor.predict_valid(
                    srv.codec.resize(im, YOLO_SIZE, YOLO_SIZE)[None])
                px = srv.pose_predictor.scale_to_original(px[0].cpu().numpy(), im.shape[:2])
                d = float(np.abs(np.asarray(body["corners"]) - px).max())
                worst_px = max(worst_px, d)
                if d > 6e-3:
                    fail(f"yolo /api/corners {i}: differs from predict_valid by {d} px")
                inf.append(body["inference_ms"])
                if i < 2:  # the one-image level outputs against the CPU predictor's
                    resized = srv.codec.resize(im, YOLO_SIZE, YOLO_SIZE)[None]
                    for a, c in zip(srv.pose_predictor.levels(resized), cpu_yolo.levels(resized)):
                        dl = (a.cpu() - c).abs()
                        lv_vs_cpu = [max(lv_vs_cpu[0], float(dl.max())),
                                     max(lv_vs_cpu[1], float(dl.mean()))]
                    if lv_vs_cpu[0] > YOLO_LEVEL_TOL[0] or lv_vs_cpu[1] > YOLO_LEVEL_TOL[1]:
                        fail(f"yolo /api/corners {i}: card vs CPU level outputs {lv_vs_cpu} "
                             f"above {YOLO_LEVEL_TOL}")
            status, body, _ = _post(srv.port, "/api/segment", bodies[0])
            if status != 503:
                fail(f"/api/segment without a checkpoint answered {status}")
        finally:
            srv.shutdown()
        emit({"phase": "server", "image_codec": srv.codec.name, "pose_family": "yolo",
              "pose_size": list(srv.pose_hw), "start_seconds": start_s,
              "warm_seconds": srv.warm_seconds, "requests": 4,
              "corners_max_abs_err_px": worst_px, "inference_ms": inf,
              "levels_card_vs_cpu_max_abs_err": lv_vs_cpu[0],
              "levels_card_vs_cpu_mean_abs_err": lv_vs_cpu[1],
              "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    return launches


def phase_yolo(torch, yolo_weights, card):
    """YoloCornerPredictor.predict at 640x640, b32 and b128; the card's bf16
    level outputs against the port's CPU path, and the card's decode against
    the CPU decode of the same level outputs (random weights give near-flat
    confidences, so the decode is not compared across devices from images)."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import YoloCornerPredictor

    s = YOLO_SIZE
    pred = YoloCornerPredictor(*yolo_weights, imgsz=s)
    for b in BATCHES:
        imgs = np.random.default_rng(SEED + 2000 + b).integers(0, 256, (b, s, s, 3), np.uint8)
        dev_imgs = torch.from_numpy(imgs).cuda()
        ms, peak, _ = _time_predict(torch, pred, dev_imgs)
        px, conf = pred.predict(dev_imgs)
        if (px.dtype, conf.dtype) != (torch.float32, torch.float32) \
                or tuple(px.shape) != (b, 4, 2) or tuple(conf.shape) != (b, 4):
            fail(f"yolo outputs {px.dtype} {tuple(px.shape)}, {conf.dtype} {tuple(conf.shape)}")
        if not (bool(torch.isfinite(px).all()) and bool(torch.isfinite(conf).all())):
            fail("yolo outputs are not finite")
        emit({"phase": "yolo_end_to_end", "batch": b, "size": [s, s], "ms_per_batch": ms,
              "img_per_s": b * 1e3 / ms, "peak_mem_bytes": peak,
              "mean_conf": float(conf.mean()),
              "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
        if b == BATCHES[-1]:
            phase_profile(torch, pred, dev_imgs, card)
        del dev_imgs, px, conf
        torch.cuda.empty_cache()

    imgs = np.random.default_rng(SEED + 2000).integers(0, 256, (2, s, s, 3), np.uint8)
    cpu = YoloCornerPredictor(*yolo_weights, imgsz=s, device="cpu")
    t0 = time.perf_counter()
    lv_card = pred.levels(imgs)
    lv_cpu = cpu.levels(imgs)
    per_level = []
    for a, c in zip(lv_card, lv_cpu):
        d = (a.cpu() - c).abs()
        per_level.append({"shape": list(a.shape), "max_abs": float(c.abs().max()),
                          "max_abs_err": float(d.max()), "mean_abs_err": float(d.mean())})
    px_card, conf_card = pred.decode(lv_card)
    px_cpu, conf_cpu = cpu.decode([a.cpu() for a in lv_card])
    d_px = float((px_card.cpu() - px_cpu).abs().max())
    d_conf = float((conf_card.cpu() - conf_cpu).abs().max())
    emit({"phase": "yolo_card_vs_cpu", "images": 2, "levels": per_level,
          "tolerance": list(YOLO_LEVEL_TOL), "decode_max_abs_err_px": d_px,
          "decode_max_abs_err_conf": d_conf, "seconds": time.perf_counter() - t0})
    want_shapes = [(2, s // st, s // st, 77) for st in (8, 16, 32)]
    if [tuple(a.shape) for a in lv_card] != want_shapes:
        fail(f"yolo level outputs {[tuple(a.shape) for a in lv_card]}")
    for lv in per_level:
        if lv["max_abs_err"] > YOLO_LEVEL_TOL[0] or lv["mean_abs_err"] > YOLO_LEVEL_TOL[1]:
            fail(f"yolo card vs CPU level outputs {lv} above {YOLO_LEVEL_TOL}")
    if d_px > 1e-3 or d_conf > 1e-6:
        fail(f"yolo card vs CPU decode of the same level outputs: {d_px} px, {d_conf} conf")


def phase_stencil_tool(torch, card):
    """tools/stencil_floor_torch.py's own run (its ``run``, what its
    ``main`` prints), with the launch count of that run."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

    tool = stencil_tool()
    _build.reset_launches()
    r = tool.run(iters=20, seed=SEED)
    n = _build.LAUNCHES.get("stencil_floor", 0)
    if n <= 0:
        fail("the stencil tool launched no stencil_floor kernel")
    if not (r["ms"]["pass"] < r["ms"]["arith"] <= r["ms"]["full"] * 1.05):
        fail(f"stencil tool times out of order: {r['ms']}")
    emit({"phase": "stencil_tool", "launches": n, **r})
    return n


TRAIN_GATE_HW, TRAIN_GATE_B = (64, 48), 2  # the CPU tests' fp32 train-step size
# card vs CPU, one fp32 train step: loss relative; each gradient tensor's
# max|d| over its own max|g|; updated BN statistics max|d|. Gradients below
# TRAIN_ZERO_GRAD of the model's largest are zero in exact arithmetic (the
# projections' BN biases, whose shift the next train-mode BN removes).
TRAIN_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-4, "batch_stats_abs": 1e-4}
TRAIN_ZERO_GRAD = 1e-5
# train-step timing shapes (the JAX package's own training sweep used these)
TRAIN_SHAPES = ((320, 240, 32), (320, 240, 128), (512, 512, 32))


def card_batch(torch, b: int, h: int, w: int, seed: int):
    """(images, masks) made on the card from ``seed``, a card segmentation
    task: per image a rectangle (each side 40-80 % of the image's, turned by
    up to 30 degrees) of a random colour, textured with the background, over
    a smooth background (a 1/16-size normal field bilinearly upsampled);
    the masks are the rectangles. Images are normalized NHWC float32."""
    import math

    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((b, 1, 1), generator=g, device="cuda")

    base = torch.randn((b, 3, max(1, h // 16), max(1, w // 16)), generator=g, device="cuda")
    bg = F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    bg = bg.permute(0, 2, 3, 1)
    yy = torch.arange(h, device="cuda", dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device="cuda", dtype=torch.float32)[None, None, :]
    dy, dx = yy - uniform(0.3, 0.7) * h, xx - uniform(0.3, 0.7) * w
    ang = uniform(-math.pi / 6, math.pi / 6)
    ry, rx = torch.cos(ang) * dy - torch.sin(ang) * dx, torch.sin(ang) * dy + torch.cos(ang) * dx
    inside = (ry.abs() <= uniform(0.2, 0.4) * h) & (rx.abs() <= uniform(0.2, 0.4) * w)
    color = torch.randn((b, 1, 1, 3), generator=g, device="cuda")
    imgs = 0.6 * bg + inside[..., None] * (color + 0.3 * bg.flip(-1))
    return imgs.contiguous(), inside.to(torch.int32)


def card_images_u8(torch, b: int, h: int, w: int, seed: int):
    """:func:`card_batch`'s images as the uint8 RGB a client would send
    (un-normalized with the ImageNet statistics), on the host, and the
    masks."""
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )

    imgs, masks = card_batch(torch, b, h, w, seed)
    mean = torch.tensor(IMAGENET_MEAN, device=imgs.device)
    std = torch.tensor(IMAGENET_STD, device=imgs.device)
    u8 = ((imgs * std + mean) * 255).round().clamp(0, 255).to(torch.uint8)
    return u8.cpu().numpy(), masks


def median_ms(torch, fn, n: int, warmup: int) -> float:
    """Median host time of ``n`` calls of ``fn``, each between two
    synchronizes, after ``warmup`` calls."""
    import statistics

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def train_state(torch, opt: dict, dtype: str = "bfloat16", weights=None, device="cuda"):
    """A train state of the full model: Flax default init from SEED, or the
    given (params, batch_stats); ``opt`` overrides the default optimizer."""
    from mtg_card_image_segmentation_tpu_torch.config import ModelConfig, OptimizerConfig
    from mtg_card_image_segmentation_tpu_torch.models import registry
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        init_flax_defaults,
        trainable_from_flax,
    )

    if weights is None:
        model = init_flax_defaults(registry.from_config(ModelConfig(compute_dtype=dtype)), SEED)
    else:
        model = trainable_from_flax(*weights, dtype=getattr(torch, dtype))
    opt_def, _ = create_optimizer(OptimizerConfig(**opt), 1, 10)
    return create_seg_state(model, opt_def, torch.device(device))


def train_gate_fp32(torch, weights, devices=("cpu", "cuda")):
    """One fp32 train step of the full model at 64x48 b2 on the card and on
    the CPU from the same weights (BN statistics off init) and batch, with
    TF32 off as main() leaves it for the whole script: loss, every gradient
    tensor, the updated BN statistics."""
    import numpy as np
    import torch.nn.functional as F

    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import flatten_tree
    from mtg_card_image_segmentation_tpu_torch.training.loop import make_train_step
    from mtg_card_image_segmentation_tpu_torch.utils.params import state_dict_to_flax

    (h, w), b = TRAIN_GATE_HW, TRAIN_GATE_B
    rng = np.random.default_rng(SEED + 64)
    base = torch.from_numpy(rng.standard_normal((b, 3, h // 8, w // 8)).astype(np.float32))
    imgs = F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    imgs = imgs.permute(0, 2, 3, 1).contiguous()
    masks = (imgs[..., 0] > 0).to(torch.int32)
    sgd = dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.05)
    out = {}
    for dev in devices:
        state = train_state(torch, sgd, "float32", weights, dev)
        _, stats = make_train_step()(state, imgs.to(dev), masks.to(dev))
        grads = state_dict_to_flax({n: p.grad for n, p in state.model.named_parameters()})[0]
        out[dev] = (float(stats["loss"]), flatten_tree(grads),
                    flatten_tree(state.variables()["batch_stats"]))
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = (out[d] for d in devices)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    gmax = max(float(np.abs(v).max()) for v in g_cpu.values())
    zero = sorted(k for k, v in g_cpu.items() if np.abs(v).max() <= TRAIN_ZERO_GRAD * gmax)
    ratios = {k: float(np.abs(g_gpu[k] - v).max() / np.abs(v).max())
              for k, v in g_cpu.items() if k not in zero}
    worst = max(ratios, key=ratios.get)
    zero_max = max((float(np.abs(g_gpu[k]).max()) / gmax for k in zero), default=0.0)
    stats_err = max(float(np.abs(s_gpu[k] - v).max()) for k, v in s_cpu.items())
    r = {"phase": "train_fp32_card_vs_cpu", "size": [h, w], "batch": b,
         "loss_cpu": l_cpu, "loss_card": l_gpu, "loss_rel_err": loss_rel,
         "grad_tensors": len(g_cpu), "grad_worst_rel_err": ratios[worst],
         "grad_worst_tensor": worst, "zero_grad_tensors": len(zero),
         "zero_grad_card_max_over_gmax": zero_max,
         "batch_stats_max_abs_err": stats_err, "tolerance": TRAIN_TOL}
    emit(r)
    if not loss_rel <= TRAIN_TOL["loss_rel"]:
        fail(f"fp32 train step: card loss {l_gpu} vs CPU {l_cpu}")
    if not ratios[worst] <= TRAIN_TOL["grad_rel"] or not zero_max <= TRAIN_ZERO_GRAD:
        fail(f"fp32 train step gradients: {worst} {ratios[worst]}, zero grads {zero_max}")
    if not stats_err <= TRAIN_TOL["batch_stats_abs"]:
        fail(f"fp32 train step BN statistics max|d| {stats_err}")


def train_loss_falls(torch, card):
    """30 bf16 steps on one fixed card-made batch at 320x240 b32, AdamW at a
    constant 1e-3: every loss finite, the last five below the first five."""
    import math

    from mtg_card_image_segmentation_tpu_torch.training.loop import make_train_step

    h, w, b = TRAIN_SHAPES[0]
    state = train_state(torch, dict(schedule="constant", warmup_epochs=0))
    imgs, masks = card_batch(torch, b, h, w, SEED + 300)
    step = make_train_step()
    losses = []
    for _ in range(30):
        _, stats = step(state, imgs, masks)
        losses.append(stats["loss"])
    losses = [float(x) for x in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    emit({"phase": "train_bf16_loss", "size": [h, w], "batch": b, "steps": 30,
          "lr": 1e-3, "losses": losses, "mean_first5": first, "mean_last5": last,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if not all(math.isfinite(x) for x in losses):
        fail(f"bf16 train losses not finite: {losses}")
    if not last < first:
        fail(f"bf16 train loss did not fall: first five {first}, last five {last}")


def train_trainer(torch, card, root: Path):
    """SegTrainer at the default config (320x240 b32, bf16, AdamW cosine
    with warmup) for 2 epochs x 8 steps, validating every epoch on 2 batches
    after recalibrating on 2, checkpointing every epoch; then resume from
    checkpoint_epoch_1 and from final_model, and serve final_model."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.config import Config
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        SegPredictor,
    )
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
    from mtg_card_image_segmentation_tpu_torch.training.trainer import SegTrainer

    cfg = Config().override({"train": {
        "num_epochs": 2, "steps_per_epoch": 8, "eval_every_epochs": 1,
        "save_every_epochs": 1, "log_every_steps": 4,
        "checkpoint_dir": str(root / "ckpts"), "log_dir": str(root / "logs")}})
    h, w, b = cfg.model.input_height, cfg.model.input_width, cfg.data.batch_size
    train = [card_batch(torch, b, h, w, SEED + 400 + i) for i in range(4)]
    val = [card_batch(torch, b, h, w, SEED + 500 + i) for i in range(2)]
    recal = [card_batch(torch, b, h, w, SEED + 600 + i)[0] for i in range(2)]

    def forever():
        while True:
            yield from train

    trainer = SegTrainer(cfg)
    _build.reset_launches()
    t0 = time.perf_counter()
    hist = trainer.train(forever(), lambda: val, lambda: recal)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    d = root / "ckpts"
    want = ["best_model", "checkpoint_epoch_1", "checkpoint_epoch_2", "final_model"]
    missing = [n for n in want if not (d / n / ckpt.ARRAYS).is_file()]
    if missing or not (d / "history.json").is_file():
        fail(f"trainer wrote no {missing or 'history.json'}")
    if len(hist["train_loss"]) != 2 or len(hist["val_mean_iou"]) != 2:
        fail(f"trainer history {sorted(hist)}")

    # resume: the step and every array bit for bit
    def same(a: dict, b: dict) -> bool:
        fa, fb = ckpt.flatten_tree(a), ckpt.flatten_tree(b)
        return set(fa) == set(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)

    ep1 = SegTrainer(cfg)
    ep1.resume("checkpoint_epoch_1")
    on_disk = ckpt.read_arrays(str(d), "checkpoint_epoch_1", ("params", "batch_stats",
                                                                "opt_state", "step"))
    ep1_ok = (ep1.state.step == 8 == int(on_disk["step"]) and ep1.start_epoch == 1
              and same(ep1.state.opt_state(), on_disk["opt_state"])
              and same(ep1.state.variables(), {k: on_disk[k] for k in ("params", "batch_stats")}))
    fin = SegTrainer(cfg)
    fin.resume("final_model")
    fin_ok = (fin.state.step == trainer.state.step == 16
              and same(fin.state.opt_state(), trainer.state.opt_state())
              and same(fin.state.variables(), trainer.state.variables()))

    # serving the trained checkpoint: b32 at 320x240 through the kernels,
    # images of the task it was trained on, 4 of them against the CPU
    # predictor from the same checkpoint
    def served(dtype=torch.bfloat16, **kw):
        return SegPredictor.from_checkpoint(str(d), "final_model", h, w, dtype=dtype, **kw)

    pred = served()
    imgs, truth = card_images_u8(torch, b, h, w, SEED + 700)
    masks = pred.predict(torch.from_numpy(imgs).cuda())
    served_acc = float((masks == truth).float().mean())
    cpu = served(device="cpu")
    agree = pred.mask_agreement(cpu, imgs[:4])
    noise = np.random.default_rng(SEED + 701).integers(0, 256, (4, h, w, 3), np.uint8)
    # bf16 decisions near the boundary may round either way: reported, not
    # gated, are bf16 on noise, the bf16 kernels against the bf16 and the
    # fp32 reference path (use_kernels=False; the kernels are bf16 only) on
    # the card, and the share of pixels whose fp32 logit margin is below
    # 0.05; gated is the fp32 reference path on noise, card against CPU
    agree_noise = pred.mask_agreement(cpu, noise)
    agree_ref16 = pred.mask_agreement(served(use_kernels=False), imgs[:4])
    ref32 = served(torch.float32, use_kernels=False)
    cpu32 = served(torch.float32, use_kernels=False, device="cpu")
    agree_ref32 = pred.mask_agreement(ref32, imgs[:4])
    agree32 = ref32.mask_agreement(cpu32, imgs[:4])
    agree32_noise = ref32.mask_agreement(cpu32, noise)
    mean, std = (torch.tensor(v, dtype=torch.float32, device="cuda")
                 for v in (IMAGENET_MEAN, IMAGENET_STD))
    with torch.inference_mode():
        logits = ref32.model((torch.from_numpy(imgs[:4]).cuda() / 255.0 - mean) / std)
    near = float(((logits[..., 1] - logits[..., 0]).abs() < 0.05).float().mean())
    emit({"phase": "train_segtrainer", "size": [h, w], "batch": b, "epochs": 2,
          "steps_per_epoch": 8, "seconds": seconds, "kernel_launches": launches,
          "history": hist, "resume_epoch_1_bit_equal": ep1_ok,
          "resume_final_bit_equal": fin_ok, "served_masks": list(masks.shape),
          "served_foreground_fraction": float(masks.float().mean()),
          "served_pixel_accuracy": served_acc,
          "served_card_vs_cpu_agreement": agree,
          "served_card_vs_cpu_agreement_noise_images": agree_noise,
          "served_kernels_vs_reference_path": agree_ref16,
          "served_kernels_vs_fp32_reference_path": agree_ref32,
          "served_fp32_reference_card_vs_cpu_agreement": agree32,
          "served_fp32_reference_card_vs_cpu_agreement_noise_images": agree32_noise,
          "served_fp32_margin_below_0.05_share": near, "card": card["name"],
          "nvidia_smi": card["nvidia_smi"]})
    if not (ep1_ok and fin_ok):
        fail(f"resume not bit-equal: epoch 1 {ep1_ok}, final {fin_ok}")
    if masks.dtype != torch.uint8 or tuple(masks.shape) != (b, h, w) or int(masks.max()) > 1:
        fail(f"served masks {masks.dtype} {tuple(masks.shape)}")
    if agree < 0.999:
        fail(f"trained checkpoint: card vs CPU mask agreement {agree} < 0.999")
    if agree32_noise < 0.999:
        fail(f"trained checkpoint, fp32 reference path: card vs CPU agreement on noise "
             f"{agree32_noise} < 0.999")
    return trainer


def train_numbers(torch, card, trainer, root: Path):
    """Train step ms, img/s and peak memory at TRAIN_SHAPES (median of 10
    steps after 3, each between synchronizes); eval, recalibration and
    checkpoint-save ms at 320x240 b32; a profile of 3 train steps there."""
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
    from mtg_card_image_segmentation_tpu_torch.training.loop import (
        make_eval_step,
        make_train_step,
        recalibrate_batch_stats,
    )

    step = make_train_step()
    rows = []
    for h, w, b in TRAIN_SHAPES:
        state = train_state(torch, {})
        imgs, masks = card_batch(torch, b, h, w, SEED + 800 + b)
        for _ in range(3):
            step(state, imgs, masks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(torch, lambda: step(state, imgs, masks), 10, 0)
        rows.append({"size": [h, w], "batch": b, "step_ms": ms, "img_per_s": b * 1e3 / ms,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()})
        del state, imgs, masks
        torch.cuda.empty_cache()
    h, w, b = TRAIN_SHAPES[0]
    state = trainer.state
    imgs, masks = card_batch(torch, b, h, w, SEED + 900)
    eval_step = make_eval_step()
    eval_ms = median_ms(torch, lambda: eval_step(state, imgs, masks), 10, 3)
    recal_ms = median_ms(torch, lambda: recalibrate_batch_stats(state, [imgs]), 10, 3)
    save_ms = median_ms(torch, lambda: ckpt.save_checkpoint(str(root), "timed", state, 0), 3, 1)
    prof = profile_calls(torch, lambda: step(state, imgs, masks), 3)
    emit({"phase": "train_numbers", "train_steps": rows,
          "eval_ms_per_batch": eval_ms, "recal_ms_per_batch": recal_ms,
          "checkpoint_save_ms": save_ms, "eval_recal_size": [h, w], "eval_recal_batch": b,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    emit({"phase": "profile", "path": "train_step", "batch": b, "size": [h, w], **prof,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})


def phase_train(torch, weights, card):
    """Segmentation training on the card: the fp32 card-vs-CPU gate, the
    bf16 loss-falls gate, SegTrainer end to end with resume and serving,
    and the training numbers."""
    train_gate_fp32(torch, weights)
    train_loss_falls(torch, card)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        trainer = train_trainer(torch, card, Path(tmp))
        train_numbers(torch, card, trainer, Path(tmp))
    del trainer
    torch.cuda.empty_cache()


# the data path at the config's training size, card vs CPU on the same
# draws (the renderer's homography is solved in float64, so the text lines'
# sin(300 v) > 0.6 and the coverage's alpha > 0.5 see the same coordinates
# on both devices and every image value is held to image_abs)
DATA_HW = (320, 240)
DATA_B = 32
FRAME_HW = (480, 640)  # the camera frame the demo sends
DATA_FRAMES = (96, 40)  # the file phase's train and test splits
DATA_TOL = {"image_abs": 1e-4, "mask_agreement": 0.9999, "corners_px": 1e-3,
            "warp_bilinear_vs_numpy": 1e-5}
MOMENT_DRAWS = 4096


def _data_bank(torch):
    """A seeded asset bank on the host at the CLI's sizes: 3 card textures
    (352x256), 3 backgrounds (320x240), 2 HDRIs (64x128) and their light
    fields (16x32, around 1): smooth random images."""
    import numpy as np
    import torch.nn.functional as F

    from mtg_card_image_segmentation_tpu_torch.data.synthetic import AssetBank

    rng = np.random.default_rng(SEED + 1000)

    def smooth(k, h, w, lo=0.0, hi=1.0):
        base = torch.from_numpy(rng.random((k, 3, h // 8, w // 8)).astype(np.float32))
        x = F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
        return (lo + (hi - lo) * x).permute(0, 2, 3, 1).contiguous()

    return AssetBank(smooth(3, 352, 256), smooth(3, *DATA_HW), smooth(2, 64, 128),
                     smooth(2, 16, 32, 0.5, 1.5))


def _data_compare(name, cpu, card) -> dict:
    """Card against CPU outputs ``(image, mask[, corners])`` of one
    function, under DATA_TOL."""
    r = {"function": name,
         "image_max_abs_err": float((card[0].float().cpu() - cpu[0].float()).abs().max()),
         "mask_agreement": float((card[1].cpu() == cpu[1]).float().mean())}
    if len(cpu) > 2 and cpu[2] is not None:
        r["corners_max_abs_err_px"] = float((card[2].cpu() - cpu[2]).abs().max())
    bad = []
    if r["image_max_abs_err"] > DATA_TOL["image_abs"]:
        bad.append(f"image max|d| {r['image_max_abs_err']}")
    if r["mask_agreement"] < DATA_TOL["mask_agreement"]:
        bad.append(f"mask agreement {r['mask_agreement']}")
    if r.get("corners_max_abs_err_px", 0.0) > DATA_TOL["corners_px"]:
        bad.append(f"corners {r['corners_max_abs_err_px']} px")
    r["failed"] = bad
    return r


def _np_warps(img, mask, sy, sx):
    """Plain numpy references of the two warps, float64 arithmetic on the
    same float32 coordinates: bilinear, zero outside [0, h-1] x [0, w-1];
    nearest, rounding half to even (``np.rint``), zero outside
    [-0.5, h-0.5)."""
    import numpy as np

    b, h, w = mask.shape
    bi = np.arange(b)[:, None, None]
    sy, sx = sy.astype(np.float64), sx.astype(np.float64)
    iy, ix = np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64)
    ok = (sy >= -0.5) & (sy < h - 0.5) & (sx >= -0.5) & (sx < w - 0.5)
    nearest = np.where(ok, mask[bi, iy.clip(0, h - 1), ix.clip(0, w - 1)], 0)
    y0, x0 = np.floor(sy).astype(np.int64), np.floor(sx).astype(np.int64)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    img = img.astype(np.float64)

    def at(yy, xx):
        return img[bi, yy.clip(0, h - 1), xx.clip(0, w - 1)]

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    ok = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
    return np.where(ok[..., None], top * (1 - wy) + bot * wy, 0.0), nearest


def data_card_vs_cpu(torch, bank_cpu, frames):
    """The data path's pure functions at 320x240 b32 on the card and on the
    CPU from the same draws (drawn on the CPU, moved to both): render_scene
    procedural and with the asset bank, the augmented render (the training
    stream), augment_batch and preprocess_batch (the first 32 camera
    frames); then the two warps on augment_batch's coordinates against
    plain numpy."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
    from mtg_card_image_segmentation_tpu_torch.data import augment as A
    from mtg_card_image_segmentation_tpu_torch.data import synthetic as S
    from mtg_card_image_segmentation_tpu_torch.data import warp as W
    from mtg_card_image_segmentation_tpu_torch.data.preprocess import preprocess_batch

    (h, w), b, cfg = DATA_HW, DATA_B, AugmentConfig()
    gen = torch.Generator().manual_seed(SEED + 1001)
    banks = {"cpu": bank_cpu, "cuda": A.to_device(bank_cpu, "cuda")}
    rows = []

    def both(name, fn, draws):
        cpu = fn(draws, "cpu")
        card = fn(A.to_device(draws, "cuda"), "cuda")
        rows.append(_data_compare(name, cpu, card))
        return cpu

    proc = both("render_scene", lambda d, dev: S.render_scene(d, h, w),
                S.draw_scene(gen, b, h, w))
    both("render_scene_asset_bank", lambda d, dev: S.render_scene(d, h, w, assets=banks[dev]),
         S.draw_scene(gen, b, h, w, assets=bank_cpu))
    both("synthetic_augmented_batch", lambda d, dev: S.render_augmented_scene(d, h, w, cfg),
         S.draw_augmented_scene(gen, b, h, w, S.NEGATIVE_PROB, cfg))
    aug = A.draw_augment(gen, b, h, w, cfg)
    both("augment_batch", lambda d, dev: A.augment_batch(
        d, proc.image.to(dev), proc.mask.to(dev), cfg), aug)
    imgs_u8, masks_u8 = (torch.from_numpy(a) for a in frames)
    both("preprocess_batch", lambda d, dev: preprocess_batch(
        imgs_u8.to(dev), masks_u8.to(dev), h, w), None)

    # the warps against numpy on augment_batch's own coordinates, with a
    # band of exact half-pixel rows where the rounding rule decides
    aug_card = A.to_device(aug, "cuda")
    m_fwd, _ = A.geometry_matrix(aug_card.geometry, h, w)
    sy, sx = W.apply_homography_grid(W.invert_affine(m_fwd), h, w)
    dy, dx = A.displacement_fields(aug_card.displacement, h, w, cfg)
    sy, sx = sy + dy, sx + dx
    sy[:, :8] = torch.arange(8, device="cuda", dtype=torch.float32)[:, None] - 0.5
    ref_b, ref_n = _np_warps(proc.image.numpy(), proc.mask.numpy(), sy.cpu().numpy(),
                             sx.cpu().numpy())
    got_n = W.warp_nearest(proc.mask.cuda(), sy, sx).cpu().numpy()
    got_b = W.warp_bilinear(proc.image.cuda(), sy, sx).cpu().numpy()
    warps = {"warp_nearest_mismatches": int((got_n != ref_n).sum()),
             "warp_bilinear_max_abs_err": float(np.abs(got_b - ref_b).max())}
    return rows, warps


def _write_frames(torch, root: Path):
    """The file phase's dataset: 96 train and 40 test JPEG frames at 480x640
    with PNG masks, rendered on the card from a seed. Returns the first 32
    frames and masks (uint8, host)."""
    import cv2
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.data.synthetic import (
        NEGATIVE_PROB,
        synthetic_batch,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1002)
    frames, masks = [], []
    while len(frames) < sum(DATA_FRAMES):
        s = synthetic_batch(gen, DATA_B, *FRAME_HW, NEGATIVE_PROB)
        frames += list((s.image * 255).round().clamp(0, 255).to(torch.uint8).cpu().numpy())
        masks += list((s.mask * 255).to(torch.uint8).cpu().numpy())
    names = ([("train", i) for i in range(DATA_FRAMES[0])]
             + [("test", i) for i in range(DATA_FRAMES[1])])
    for k, (split, i) in enumerate(names):
        for sub in ("images", "masks"):
            (root / split / sub).mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(root / split / "images" / f"{i:04d}.jpg"), frames[k][..., ::-1])
        cv2.imwrite(str(root / split / "masks" / f"{i:04d}.png"), masks[k])
    return np.stack(frames[:DATA_B]), np.stack(masks[:DATA_B])


def data_pipelines(torch):
    """SyntheticPipeline at 320x240 b32, with and without augmentation:
    ms/batch (median of 10 after 3, each between synchronizes), device
    events and kernel time per batch (profile of 3), peak memory above the
    phase's start, foreground and negative shares of the timed batches."""
    from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
    from mtg_card_image_segmentation_tpu_torch.data.pipeline import SyntheticPipeline

    rows = []
    for aug in (AugmentConfig(), None):
        pipe = SyntheticPipeline(DATA_B, *DATA_HW, augment=aug, seed=SEED)
        fg = []
        ms = median_ms(torch, lambda: fg.append(pipe.next_batch()[1].float().mean((1, 2))),
                       10, 3)
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pipe.next_batch()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - start
        prof = profile_calls(torch, pipe.next_batch, 3)
        fg = torch.cat(fg)
        rows.append({"augment": aug is not None, "ms_per_batch": ms,
                     "img_per_s": DATA_B * 1e3 / ms, "peak_mem_bytes_above_start": peak,
                     "kernel_ms_per_batch": prof["kernel_ms_per_call"],
                     "device_events_per_batch": prof["kernel_launches_per_call"],
                     "device_idle_share": prof["device_idle_share"],
                     "top_classes": prof["classes"][:4],
                     "foreground_share": float(fg.mean()),
                     "negative_share": float((fg == 0).float().mean()),
                     "samples": fg.numel()})
    return rows


def data_files(torch, root: Path):
    """FilePipeline over the written dataset (96 frames at 480x640 -> 320x240
    b32, 3 batches an epoch): host decode ms per image, and ms/batch over two
    epochs after one, augmentation off and on; nothing but the pipeline
    consumes the batches."""
    from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
    from mtg_card_image_segmentation_tpu_torch.data.dataset import CardSegmentationDataset
    from mtg_card_image_segmentation_tpu_torch.data.pipeline import FilePipeline

    ds = CardSegmentationDataset(str(root / "train" / "images"), str(root / "train" / "masks"))
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds.load_raw(i)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
    rows = []
    for aug in (None, AugmentConfig()):
        pipe = FilePipeline(ds, DATA_B, *DATA_HW, augment=aug, seed=SEED)
        list(pipe)
        torch.cuda.synchronize()
        t0, batches = time.perf_counter(), 0
        for _ in range(2):
            for images, _masks, _valid in pipe:
                batches += 1
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / batches
        rows.append({"augment": aug is not None, "ms_per_batch": ms, "batches": batches,
                     "img_per_s": DATA_B * 1e3 / ms, "images_shape": list(images.shape)})
    return {"frames": len(ds), "frame_hw": list(FRAME_HW),
            "host_decode_ms_per_image": decode_ms,
            "host_decode_ms_per_batch": decode_ms * DATA_B, "pipelines": rows}


def data_moments(torch):
    """Rates of the draws on the card against the config, each to be within
    4 sigma of its probability over 4,096 draws."""
    import math

    from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
    from mtg_card_image_segmentation_tpu_torch.data.augment import draw_augment
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import NEGATIVE_PROB, draw_scene

    cfg = AugmentConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1003)
    a = draw_augment(gen, MOMENT_DRAWS, 2, 3, cfg)
    s = draw_scene(gen, MOMENT_DRAWS, 2, 3, NEGATIVE_PROB)
    out = {}
    for name, x, p in (("flip", a.geometry.do_flip, cfg.hflip_prob),
                       ("affine", a.geometry.do_affine, cfg.affine_prob),
                       ("elastic", a.displacement.do_elastic, cfg.elastic_prob),
                       ("grid", a.displacement.do_grid, cfg.grid_distort_prob),
                       ("negative", ~s.has_card, NEGATIVE_PROB)):
        rate = float(x.float().mean())
        out[name] = {"rate": rate, "config": p,
                     "sigmas": (rate - p) / math.sqrt(p * (1 - p) / MOMENT_DRAWS)}
    return out


def phase_data(torch, card, root: Path) -> Path:
    """The data path on the card: card vs CPU on the same draws, the warps
    against numpy, the two pipelines' ms/batch, device events and memory,
    the draws' rates. Returns the directory of the file dataset."""
    t0 = time.perf_counter()
    ds_root = root / "dataset"
    frames = _write_frames(torch, ds_root)
    rows, warps = data_card_vs_cpu(torch, _data_bank(torch), frames)
    synthetic = data_pipelines(torch)
    files = data_files(torch, ds_root)
    moments = data_moments(torch)
    emit({"phase": "data", "size": list(DATA_HW), "batch": DATA_B,
          "card_vs_cpu": rows, "warps_vs_numpy": warps, "tolerance": DATA_TOL,
          "synthetic_pipeline": synthetic, "file_pipeline": files, "draw_rates": moments,
          "seconds": time.perf_counter() - t0,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    bad = [f"{r['function']}: {r['failed']}" for r in rows if r["failed"]]
    if warps["warp_nearest_mismatches"]:
        bad.append(f"warp_nearest vs numpy: {warps['warp_nearest_mismatches']} pixels")
    if warps["warp_bilinear_max_abs_err"] > DATA_TOL["warp_bilinear_vs_numpy"]:
        bad.append(f"warp_bilinear vs numpy: {warps['warp_bilinear_max_abs_err']}")
    bad += [f"{k} rate {v['rate']} vs {v['config']}" for k, v in moments.items()
            if abs(v["sigmas"]) > 4]
    if bad:
        fail(f"data: {bad}")
    return ds_root


def _cli(args, name: str, root: Path, script: str = "train_seg_torch.py",
         exits=(0,)) -> dict:
    """One of the port's CLIs (``script``) in a subprocess: its exit code,
    wall time, the ms/step it logs, the device it reports, its log lines of
    note; its output is kept in ``root``. An exit code not in ``exits``
    fails; a caller that allows another reads the log to say why."""
    cmd = [sys.executable, str(ROOT / script), *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    (root / f"{name}.log").write_text(out.stdout + out.stderr)
    if out.returncode not in exits:
        fail(f"{script} {name}: exit {out.returncode}: {(out.stdout + out.stderr)[-3000:]}")
    dev = re.search(r"device (cuda.*)", out.stdout)
    return {"run": name, "exit": out.returncode, "wall_seconds": seconds,
            "logged_ms_per_step": [float(x) for x in re.findall(r"([\d.]+)ms/step", out.stdout)],
            "device": dev.group(1) if dev else None,
            "log": [ln.split("] ", 1)[-1] for ln in out.stdout.splitlines()
                    if re.search(r"ms/step|VAL|Resumed|parity|iou_card|sparsity|--slim|"
                                 r"mixed-precision", ln)]}


def phase_train_cli(torch, card, root: Path, ds_root: Path) -> dict:
    """``train_seg_torch.py`` on the card at the default config (320x240
    b32): synthetic 2 epochs x 8 steps, ``--resume`` of a third epoch, the
    file source for 2 epochs of 3 steps on the data phase's dataset (a
    process's first step pays its warm-up, so an epoch's logged ms/step is
    steady from the second epoch on); then
    the synthetic run's ``final_model`` served at b32 on fresh rendered
    validation images through kernels 1-3, gated card vs CPU as the
    ``train_segtrainer`` phase gates its checkpoint. Returns the serving
    call's kernel launches."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import (
        NEGATIVE_PROB,
        synthetic_batch,
    )
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

    h, w = DATA_HW
    syn = root / "ckpt_synthetic"

    def sets(ckpt, epochs, *extra):
        return ["--set", f"train.num_epochs={epochs}", "train.save_every_epochs=1",
                "train.log_every_steps=8", f"train.checkpoint_dir={ckpt}",
                f"train.log_dir={root / 'logs'}", *extra]

    runs = [_cli(["--source", "synthetic", *sets(syn, 2, "train.steps_per_epoch=8")],
                 "synthetic", root),
            _cli(["--source", "synthetic", "--resume",
                  *sets(syn, 3, "train.steps_per_epoch=8")], "resume", root),
            _cli(["--source", "files", *sets(root / "ckpt_files", 2,
                                             f"data.dataset_root={ds_root}")], "files", root)]
    hist = json.loads((syn / "history.json").read_text())
    hist_files = json.loads((root / "ckpt_files" / "history.json").read_text())

    def served(dtype=torch.bfloat16, **kw):
        return SegPredictor.from_checkpoint(str(syn), "final_model", h, w, dtype=dtype, **kw)

    pred = served()
    s = synthetic_batch(torch.Generator(device="cuda").manual_seed(30_000), DATA_B, h, w,
                        NEGATIVE_PROB)
    imgs = (s.image * 255).round().clamp(0, 255).to(torch.uint8)
    pred.predict(imgs)
    torch.cuda.synchronize()
    _build.reset_launches()
    masks = pred.predict(imgs)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    acc = float((masks == s.mask).float().mean())
    host = imgs[:4].cpu().numpy()
    noise = np.random.default_rng(SEED + 1004).integers(0, 256, (4, h, w, 3), np.uint8)
    cpu = served(device="cpu")
    agree = pred.mask_agreement(cpu, host)
    ref32 = served(torch.float32, use_kernels=False)
    cpu32 = served(torch.float32, use_kernels=False, device="cpu")
    agree32 = ref32.mask_agreement(cpu32, host)
    agree32_noise = ref32.mask_agreement(cpu32, noise)
    # reported beside the gates, the witnesses if the bf16 gate fails
    with torch.inference_mode():
        mean, std = (torch.tensor(v, device="cuda") for v in (IMAGENET_MEAN, IMAGENET_STD))
        logits = ref32.model((imgs[:4].float() / 255.0 - mean) / std)
    witness = {"bf16_card_vs_cpu_agreement_noise_images": pred.mask_agreement(cpu, noise),
               "kernels_vs_fp32_reference_path": pred.mask_agreement(ref32, host),
               "fp32_margin_below_0.05_share":
                   float(((logits[..., 1] - logits[..., 0]).abs() < 0.05).float().mean())}
    emit({"phase": "train_cli", "size": [h, w], "batch": DATA_B, "runs": runs,
          "history_val_mean_iou": hist.get("val_mean_iou"),
          "history_train_loss": hist.get("train_loss"),
          "files_history_val_mean_iou": hist_files.get("val_mean_iou"),
          "served_launches": launches, "served_pixel_accuracy": acc,
          "served_foreground_fraction": float(masks.float().mean()),
          "served_card_vs_cpu_agreement": agree,
          "served_fp32_reference_card_vs_cpu_agreement": agree32,
          "served_fp32_reference_card_vs_cpu_agreement_noise_images": agree32_noise,
          "reported": witness, "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if len(hist.get("val_mean_iou", [])) != 3 or len(hist_files.get("val_mean_iou", [])) != 2:
        fail(f"train_cli histories: {hist.get('val_mean_iou')}, {hist_files.get('val_mean_iou')}")
    if any(r["device"] is None or not r["device"].startswith("cuda") for r in runs):
        fail(f"train_cli ran off the card: {[r['device'] for r in runs]}")
    _check_seg_launches("train_cli_served", launches)
    if agree < 0.999:
        fail(f"CLI checkpoint: bf16 card vs CPU agreement {agree} < 0.999")
    if agree32 < 0.999 or agree32_noise < 0.999:
        fail(f"CLI checkpoint, fp32 reference path: card vs CPU {agree32}, noise {agree32_noise}")
    return launches

CE_TOL = {"eval_confusion_share": 1e-4, "eval_iou_abs": 1e-4, "sparsity_abs": 1e-3,
          "served_agreement": 0.999}
ARTIFACTS = ("model.onnx", "model_fp16.onnx", "model_int8.onnx", "model_dynamic.onnx",
             "params.npz")


def compress_eval_card_vs_cpu(torch, ckpt: Path):
    """``SegEvaluator`` with the fp32 model of ``ckpt`` on the card and on
    the CPU over the same two rendered batches (320x240 b32; a threshold
    above 1 mines every image, so the report lists each image's IoU), and
    the evaluation's ms/batch on the card with the CLI's bf16 model (one
    ``evaluate`` call over one batch: the forward, the analysis, the host
    copies; median of 5 after 2)."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.config import default_config
    from mtg_card_image_segmentation_tpu_torch.data.preprocess import normalize_only
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import NEGATIVE_PROB, synthetic_batch
    from mtg_card_image_segmentation_tpu_torch.evaluation import SegEvaluator
    from mtg_card_image_segmentation_tpu_torch.models import registry
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import flax_to_state_dict, from_flax

    params, stats, _ = load_params(str(ckpt.parent), ckpt.name)
    batches = []
    for i in range(2):
        s = synthetic_batch(torch.Generator(device="cuda").manual_seed(40_000 + i), DATA_B,
                            *DATA_HW, NEGATIVE_PROB)
        batches.append((normalize_only(s.image), s.mask))
    reps = {}
    for dev in ("cuda", "cpu"):
        model = from_flax(params, stats, dtype=torch.float32).to(dev)
        reps[dev] = SegEvaluator(model).evaluate(
            [(x.to(dev), m.to(dev)) for x, m in batches], failure_iou_threshold=2.0,
            max_failures=2 * DATA_B, worst_k=0)
    cm = {d: np.asarray(r["confusion_matrix"]) for d, r in reps.items()}
    iou = {d: np.asarray([f["iou"] for f in r["failures"]]) for d, r in reps.items()}
    cfg = default_config()
    bf16 = registry.from_config(cfg.model)
    bf16.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    ev = SegEvaluator(bf16.to("cuda"))
    ms = median_ms(torch, lambda: ev.evaluate([batches[0]], worst_k=0), 5, 2)
    pixels = int(cm["cpu"].sum())
    return {"pixels": pixels, "images": len(iou["cpu"]),
            "confusion_card": cm["cuda"].tolist(), "confusion_cpu": cm["cpu"].tolist(),
            "confusion_max_abs_diff_share": float(np.abs(cm["cuda"] - cm["cpu"]).max()) / pixels,
            "per_image_iou_max_abs_diff": float(np.abs(iou["cuda"] - iou["cpu"]).max()),
            "iou_card_card": reps["cuda"]["metrics"]["iou_card"],
            "iou_card_cpu": reps["cpu"]["metrics"]["iou_card"],
            "eval_ms_per_batch_bf16_b32": ms}


def executor_card_vs_cpu(torch, export_dir: Path, params, stats) -> list:
    """Every ONNX artifact of ``export_dir`` run by the torch executor on the
    card and on the CPU on the export CLI's probe (standard normal, seed 0,
    b1; the dynamic graph also at b4, seed 1). The float32 graphs (fp32,
    dynamic, int8 QDQ) must agree within 1e-5 of the largest logit (float32
    rounding through 52 layers; cuDNN and the CPU sum in other orders). The
    fp16 graph runs in float16 on both: the card's logits may be no further
    from the fp32 model's than twice the CPU's are (a wrong fp16 kernel
    misses by its outputs' size)."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
    from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax

    h, w = DATA_HW
    x1 = np.random.default_rng(0).standard_normal((1, 3, h, w)).astype(np.float32)
    x4 = np.random.default_rng(1).standard_normal((4, 3, h, w)).astype(np.float32)
    with torch.inference_mode():
        ref = from_flax(params, stats, dtype=torch.float32)(
            torch.from_numpy(np.ascontiguousarray(x1.transpose(0, 2, 3, 1)))).numpy()
    ref = ref.transpose(0, 3, 1, 2)
    rows = []
    for art, x in (("model.onnx", x1), ("model_dynamic.onnx", x1), ("model_dynamic.onnx", x4),
                   ("model_int8.onnx", x1), ("model_fp16.onnx", x1)):
        graph = op.Model.load(str(export_dir / art))
        card, host = (make_runner(graph, dev)({"input": x})["output"] for dev in ("cuda", "cpu"))
        row = {"artifact": art, "batch": x.shape[0], "finite": bool(np.isfinite(card).all()),
               "card_vs_cpu_max_abs": float(np.abs(card - host).max()),
               "logit_max_abs": float(np.abs(host).max()),
               "mask_agreement_card_vs_cpu": float((card.argmax(1) == host.argmax(1)).mean())}
        if art == "model_fp16.onnx":
            row["card_vs_fp32_model"] = float(np.abs(card - ref).max())
            row["cpu_vs_fp32_model"] = float(np.abs(host - ref).max())
            row["pass"] = row["finite"] and row["card_vs_fp32_model"] <= 2 * row["cpu_vs_fp32_model"]
        else:
            row["pass"] = row["finite"] and (row["card_vs_cpu_max_abs"]
                                             <= 1e-5 * row["logit_max_abs"])
        rows.append(row)
    return rows


EXPORT_GATE = re.compile(r"^(fp32|fp16|int8|dynamic-batch) parity( b\d)?: .* (PASS|FAIL)$")


def export_gate_verdicts(log: str) -> dict:
    """The export CLI's final verdict per gate, from its log: ``fp32``,
    ``fp16`` (after any mixed-precision rewrite), ``int8``, ``dynamic b1``,
    ``dynamic b4`` -> "PASS" or "FAIL"."""
    out = {}
    for ln in log.splitlines():
        m = EXPORT_GATE.match(ln)
        if m:
            out[m.group(1).replace("-batch", "") + (m.group(2) or "")] = m.group(3)
    return out


EXPORT_READING = re.compile(r"^(fp32|dynamic-batch) parity( b\d)?: max\|diff\|=(\S+) ")
# the absolute float32 gates (max|diff| < 1e-4) and how far the card's
# reading may lie from the CPU's on the same checkpoint and probe
REFEREED_GATES = ("fp32", "dynamic b1", "dynamic b4")
REFEREE_FACTOR = 2.0


def export_gate_readings(log: str) -> dict:
    """The export CLI's max|diff| per absolute float32 gate, from its log:
    ``fp32``, ``dynamic b1``, ``dynamic b4`` -> float."""
    out = {}
    for ln in log.splitlines():
        m = EXPORT_READING.match(ln)
        if m:
            out[m.group(1).replace("-batch", "") + (m.group(2) or "")] = float(m.group(3))
    return out


def export_gate_refereed(verdicts: dict, card: dict, cpu: dict) -> frozenset:
    """The absolute float32 gates that the card's export missed only by
    float32 rounding: each whose card reading is at most REFEREE_FACTOR
    times the same CLI's reading on the CPU from the same checkpoint. The
    1e-4 gate is absolute, and for some short runs' checkpoints it sits
    inside fp32 rounding on either device; a fault of the card misses by
    more than the CPU's rounding does."""
    return frozenset(g for g in REFEREED_GATES if verdicts.get(g) == "FAIL"
                     and g in card and g in cpu and card[g] <= REFEREE_FACTOR * cpu[g])


# the float64 referee of a seg export's float32 gate (export_gate_float64):
# the artifact each gate runs; how closely the card's float64 run must
# reproduce the CPU's (float64 rounding is ~1e-15); and how far a float32
# run may lie from its float64 value, both of the largest logit (the
# float32 tolerance executor_card_vs_cpu holds the card's graphs to)
SEG_GATE_GRAPH = {"fp32": "model.onnx", "dynamic b1": "model_dynamic.onnx",
                  "dynamic b4": "model_dynamic.onnx"}
FLOAT64_AGREE = 1e-10
FLOAT32_ROUNDING = 1e-5


def export_gate_float64(torch, graph_path: Path, source, x, devices=("cuda", "cpu")) -> dict:
    """The float64 referee of one absolute float32 seg export gate. The
    reading max|graph - model| is the largest of ~10^5 float32 rounding
    sums, amplified at a few ill-conditioned logits, so one probe's reading
    on two devices can part by more than 2x on a correct card (the CPU
    read 3.1x the card's on one 24-step checkpoint). On the gate's own
    probe ``x`` (NCHW), the artifact at ``graph_path`` and the float32
    source model ``source()`` run on ``devices`` (the card inside
    ``ieee_fp32()``, as the CLI runs them, then the CPU), each in float32
    and in float64. The reading splits into the graph's float32 rounding,
    the model's, and the export's own error (the graph's float64 output
    against the model's). Returned: both readings; the float64 outputs
    card vs CPU over the largest logit (does the card compute the same
    function); the export's error in float64; and each float32 run's
    max|float32 - float64| over the largest logit, [card, CPU]."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
    from mtg_card_image_segmentation_tpu_torch.training.loop import float64_casts, float64_copy
    from mtg_card_image_segmentation_tpu_torch.utils.platform import ieee_fp32

    graph = op.Model.load(str(graph_path))
    nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    outs = []
    for dev in devices:
        m32 = source().to(dev)
        m64 = float64_copy(m32)
        xt = torch.from_numpy(nhwc).to(dev)
        with ieee_fp32(), torch.inference_mode():
            r32 = m32(xt).cpu().numpy()
            with float64_casts():
                r64 = m64(xt.double()).cpu().numpy()
            g32 = make_runner(graph, dev)({"input": x})["output"]
            g64 = make_runner(graph, dev, torch.float64)({"input": x})["output"]
        outs.append((g32, r32.transpose(0, 3, 1, 2), g64, r64.transpose(0, 3, 1, 2)))
    (g32c, r32c, g64c, r64c), (g32h, r32h, g64h, r64h) = outs

    def amax(a):
        return float(np.abs(a).max())

    scale = amax(r64h)
    return {"reading_card": amax(g32c - r32c), "reading_cpu": amax(g32h - r32h),
            "logit_max_abs": scale,
            "float64_card_vs_cpu": max(amax(g64c - g64h), amax(r64c - r64h)) / scale,
            "export_error_float64": amax(g64h - r64h),
            "graph_rounding": [amax(g32c - g64h) / scale, amax(g32h - g64h) / scale],
            "model_rounding": [amax(r32c - r64h) / scale, amax(r32h - r64h) / scale]}


def export_gate_rounding_excused(row: dict, atol: float) -> bool:
    """A float32 gate's miss is float32 rounding of a right artifact on a
    right card where, on the gate's probe (``export_gate_float64``): the
    card's float64 outputs are the CPU's within FLOAT64_AGREE of the
    largest logit (the card computes the same function); the artifact
    computes the model within the gate's ``atol`` in float64; and the
    card's float32 graph and model each lie within FLOAT32_ROUNDING of the
    largest logit from their float64 values."""
    return (row["float64_card_vs_cpu"] <= FLOAT64_AGREE
            and row["export_error_float64"] < atol
            and max(row["graph_rounding"][0], row["model_rounding"][0]) <= FLOAT32_ROUNDING)


def export_gate_faults(run: dict, verdicts: dict, may_miss: frozenset) -> list:
    """What is wrong with one export CLI run: a gate it did not report, a
    missed gate outside ``may_miss``, or an exit code that disagrees with
    its verdicts (0 when every gate passed, else 1)."""
    want = ("fp32", "fp16", "int8", "dynamic b1", "dynamic b4")
    missed = {k for k, v in verdicts.items() if v == "FAIL"}
    bad = [f"gate {k} not reported" for k in want if k not in verdicts]
    bad += [f"gate {k} FAIL" for k in sorted(missed - may_miss)]
    if run["exit"] != (1 if missed else 0):
        bad.append(f"exit {run['exit']} with verdicts {verdicts}")
    return bad


def phase_compress_export(torch, card, root: Path, ds_root: Path) -> dict:
    """Evaluation, pruning and ONNX export of the ``train_cli`` phase's
    checkpoint on the card at the default config (320x240 b32):
    ``evaluate_seg_torch.py`` on the synthetic source (4 batches) and on the
    data phase's test split (40 frames, the tail batch padded), the
    evaluator card vs CPU in this process; ``prune_seg_torch.py`` with the
    expansion method and an 8-step masked fine-tune, then the magnitude
    method; ``export_seg_torch.py`` of the slimmed pruned checkpoint and of
    the dense one, each gating its artifacts with the torch executor on the
    card (fp32 < 1e-4, fp16 in probability space, int8, dynamic b1 and b4).
    The slim export must pass every gate and exit 0. The dense checkpoint
    of 24 training steps may miss the fp16 and int8 gates, and then exits
    1: on a noise probe a barely trained model has many pixels near its
    decision boundary (a seeded untrained tree misses both in both
    packages, ``tests/test_torch_export.py``); its fp32 and dynamic gates
    must pass. Where the card misses an absolute float32 gate (fp32,
    dynamic b1 or b4, max|diff| < 1e-4), the same CLI runs on the CPU from
    the same checkpoint, and that gate is excused only where the card's
    max|diff| is at most twice the CPU's (``export_gate_refereed``), or,
    beyond that, where the float64 referee on the gate's own probe finds
    the card computing the CPU's function and the artifact the model's,
    and the card's float32 runs within 1e-5 of the largest logit of their
    float64 values (``export_gate_float64``): the 1e-4 gate sits inside
    fp32 rounding for some of these short runs' checkpoints, on either
    device, and one probe's maximum parts by more than 2x between devices.
    The float64 referee runs on every float32 gate of both exports, and
    each must show the card's float64 outputs within FLOAT64_AGREE of the
    CPU's and the artifact's float64 error under the gate. Every artifact
    is also held card vs CPU (``executor_card_vs_cpu``). Then the pruned checkpoint is slimmed and
    served at b32 through kernels 1-3, against the CPU and against its
    exported ``model_dynamic.onnx``. Returns the serving call's kernel
    launches."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.compression import sparsity_report
    from mtg_card_image_segmentation_tpu_torch.compression.slim import (
        expansion_channel_prune,
        slim_seg_state,
    )
    from mtg_card_image_segmentation_tpu_torch.config import default_config
    from mtg_card_image_segmentation_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import NEGATIVE_PROB, synthetic_batch
    from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import flatten_tree, load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax
    from export_seg_torch import gate_probes

    t_start = time.perf_counter()
    h, w = DATA_HW
    probes, atol = gate_probes(h, w), default_config().export.parity_atol_fp32
    final = root / "ckpt_synthetic" / "final_model"
    quiet = ["--failure-threshold", "0", "--worst-k", "0"]  # no panels: no matplotlib here
    runs = [_cli(["--checkpoint", str(final), "--source", "synthetic", "--batches", "4",
                  "--output-dir", str(root / "eval_synthetic"), *quiet],
                 "evaluate_synthetic", root, "evaluate_seg_torch.py"),
            _cli(["--checkpoint", str(final), "--source", "files",
                  "--output-dir", str(root / "eval_files"), *quiet,
                  "--set", f"data.dataset_root={ds_root}"],
                 "evaluate_files", root, "evaluate_seg_torch.py")]
    evals = {r: json.loads((root / r / "evaluation_report.json").read_text())
             for r in ("eval_synthetic", "eval_files")}
    in_process = compress_eval_card_vs_cpu(torch, final)

    pruned = {m: root / f"pruned_{m}" for m in ("expansion", "magnitude")}
    runs += [_cli(["--checkpoint", str(final), "--method", "expansion", "--amount", "0.3",
                   "--fine-tune-epochs", "1", "--fine-tune-steps", "8", "--eval-batches", "4",
                   "--output-dir", str(pruned["expansion"])],
                  "prune_expansion", root, "prune_seg_torch.py"),
             _cli(["--checkpoint", str(final), "--method", "magnitude", "--amount", "0.3",
                   "--eval-batches", "4", "--output-dir", str(pruned["magnitude"])],
                  "prune_magnitude", root, "prune_seg_torch.py")]
    prune_reports = {m: json.loads((d / "pruning_report.json").read_text())
                     for m, d in pruned.items()}
    base_params, _, _ = load_params(str(final.parent), final.name)
    _, masks = expansion_channel_prune(base_params, 0.3)
    saved = {m: load_params(str(d), "pruned_model") for m, d in pruned.items()}
    flat_saved = flatten_tree(saved["expansion"][0])
    masked_nonzero = sum(int((flat_saved[k][v == 0] != 0).sum())
                         for k, v in flatten_tree(masks).items())
    sparsity_file = {m: sparsity_report(p)["global_sparsity"] for m, (p, _, _) in saved.items()}

    # the export: the CLI gates its artifacts on the card and exits 1 when
    # a gate misses (export_seg.py's verdict); every artifact is then run by
    # the executor on the card and on the CPU
    may_miss = {"slim": frozenset(), "dense": frozenset({"fp16", "int8"})}
    sp, ss, overrides = slim_seg_state(saved["expansion"][0], saved["expansion"][1])
    sources = {"slim": (sp, ss), "dense": load_params(str(final.parent), final.name)[:2]}
    exports = {"slim": root / "export_slim", "dense": root / "export_dense"}
    export_args = {"slim": ["--checkpoint", str(pruned["expansion"] / "pruned_model"), "--slim"],
                   "dense": ["--checkpoint", str(final)]}
    export_runs = {k: _cli([*a, "--output-dir", str(exports[k])], f"export_{k}", root,
                           "export_seg_torch.py", exits=(0, 1))
                   for k, a in export_args.items()}
    runs += list(export_runs.values())
    exported = {}
    for k, d in exports.items():
        log = (root / f"export_{k}.log").read_text()
        verdicts = export_gate_verdicts(log)
        readings, cpu_readings, refereed = export_gate_readings(log), None, frozenset()
        # the float64 referee on every float32 gate, missed or not: its
        # float64 card-vs-CPU agreement and the artifact's float64 error
        # are held on every run (below)
        float64_rows = {g: export_gate_float64(
            torch, d / SEG_GATE_GRAPH[g],
            lambda k=k: from_flax(*sources[k], dtype=torch.float32), probes[g])
            for g in REFEREED_GATES}
        if {g for g, v in verdicts.items() if v == "FAIL"} & set(REFEREED_GATES):
            # the same CLI on the CPU from the same checkpoint: its readings
            # say how far float32 rounding alone takes this checkpoint
            _cli([*export_args[k], "--device", "cpu", "--output-dir", f"{d}_cpu"],
                 f"export_{k}_cpu", root, "export_seg_torch.py", exits=(0, 1))
            cpu_readings = export_gate_readings((root / f"export_{k}_cpu.log").read_text())
            refereed = export_gate_refereed(verdicts, readings, cpu_readings)
            # a miss beyond twice the CPU's reading: the float64 referee
            refereed |= {g for g in REFEREED_GATES if verdicts.get(g) == "FAIL"
                         and export_gate_rounding_excused(float64_rows[g], atol)}
        exported[k] = {
            "cli_exit": export_runs[k]["exit"],
            "cli_gates": [ln for ln in log.splitlines() if re.match(r"\S+ parity", ln)],
            "cli_verdicts": verdicts, "may_miss": sorted(may_miss[k]),
            "card_readings": readings, "cpu_referee_readings": cpu_readings,
            "float64_referee": float64_rows, "refereed": sorted(refereed),
            "cli_faults": export_gate_faults(export_runs[k], verdicts, may_miss[k] | refereed),
            "cli_used_mixed_precision": "rewritten mixed-precision" in log,
            "model_info_parity": (json.loads((d / "model_info.json").read_text())["parity"]
                                  if (d / "model_info.json").exists() else None),
            "export_seconds": json.loads(re.search(r"export seconds (\{.*\})", log).group(1)),
            "sizes_mb": {a: (d / a).stat().st_size / 1e6 for a in ARTIFACTS},
            "executor_card_vs_cpu": executor_card_vs_cpu(torch, d, *sources[k])}
    # each export's torch.export artifact: the CLI's self-test, MB, seconds
    bad_programs = []
    for k, d in exports.items():
        exported[k]["torch_export"], b = program_fields(d / "model.pt2")
        bad_programs += [f"export {k}: {x}" for x in b]
    # the pruned checkpoint, slimmed, served through kernels 1-3
    pred = SegPredictor(sp, ss, h, w)
    s = synthetic_batch(torch.Generator(device="cuda").manual_seed(30_000), DATA_B, h, w,
                        NEGATIVE_PROB)
    imgs = (s.image * 255).round().clamp(0, 255).to(torch.uint8)
    pred.predict(imgs)
    torch.cuda.synchronize()
    _build.reset_launches()
    masks_card = pred.predict(imgs)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    host = imgs[:4].cpu().numpy()
    agree_cpu = pred.mask_agreement(SegPredictor(sp, ss, h, w, device="cpu"), host)
    ref32 = SegPredictor(sp, ss, h, w, dtype=torch.float32, use_kernels=False)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)

    def onnx_input(u8):
        return np.ascontiguousarray(((u8.astype(np.float32) / 255.0 - mean) / std)
                                    .transpose(0, 3, 1, 2))

    dyn = make_runner(op.Model.load(str(exports["slim"] / "model_dynamic.onnx")))
    onnx_mask = dyn({"input": onnx_input(host)})["output"].argmax(axis=1)
    agree_onnx = float((ref32.predict(host).cpu().numpy() == onnx_mask).mean())

    # the executor's ms per call beside the fp32 reference path on the same input
    timing = {}
    for k, d in exports.items():
        ref = SegPredictor(*sources[k], h, w, dtype=torch.float32, use_kernels=False)
        static = make_runner(op.Model.load(str(d / "model.onnx")))
        dynamic = make_runner(op.Model.load(str(d / "model_dynamic.onnx")))
        x1, x4 = onnx_input(host[:1]), onnx_input(host)
        timing[k] = {
            "runner_model_onnx_b1_ms": median_ms(torch, lambda: static({"input": x1}), 5, 2),
            "runner_model_dynamic_onnx_b4_ms": median_ms(torch, lambda: dynamic({"input": x4}),
                                                         5, 2),
            "seg_predictor_fp32_reference_b1_ms": median_ms(
                torch, lambda: ref.predict(host[:1]).cpu(), 5, 2),
            "seg_predictor_fp32_reference_b4_ms": median_ms(
                torch, lambda: ref.predict(host).cpu(), 5, 2)}

    emit({"phase": "compress_export", "size": [h, w], "batch": DATA_B,
          "runs": [{k: v for k, v in r.items() if k != "logged_ms_per_step"} | (
              {"fine_tune_ms_per_step": r["logged_ms_per_step"]} if r["logged_ms_per_step"]
              else {}) for r in runs],
          "evaluate": {k: {"num_images": v["num_images"], "iou_card": v["metrics"]["iou_card"],
                           "pixel_accuracy": v["metrics"]["pixel_accuracy"],
                           "confusion_matrix": v["confusion_matrix"]}
                       for k, v in evals.items()},
          "evaluator_card_vs_cpu": in_process,
          "prune": {m: {"iou_card_before": r["before"]["iou_card"],
                        "iou_card_after": r["after"]["iou_card"],
                        "sparsity_reported": r["sparsity"]["global_sparsity"],
                        "sparsity_in_file": sparsity_file[m]}
                    for m, r in prune_reports.items()},
          "expansion_masked_entries_nonzero_in_file": masked_nonzero,
          "export": exported,
          "served": {"expanded_widths": list(overrides), "launches": launches,
                     "foreground_fraction": float(masks_card.float().mean()),
                     "pixel_accuracy": float((masks_card == s.mask).float().mean()),
                     "bf16_card_vs_cpu_agreement": agree_cpu,
                     "fp32_reference_vs_onnx_dynamic_b4_agreement": agree_onnx},
          "timing": timing, "tolerance": CE_TOL,
          "seconds": time.perf_counter() - t_start,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    bad = bad_programs
    if any(r["device"] is None or not r["device"].startswith("cuda") for r in runs):
        bad.append(f"a CLI ran off the card: {[r['device'] for r in runs]}")
    if evals["eval_files"]["num_images"] != DATA_FRAMES[1]:
        bad.append(f"files evaluation counted {evals['eval_files']['num_images']} images")
    if in_process["confusion_max_abs_diff_share"] > CE_TOL["eval_confusion_share"]:
        bad.append(f"evaluator card vs CPU confusion {in_process['confusion_max_abs_diff_share']}")
    if in_process["per_image_iou_max_abs_diff"] > CE_TOL["eval_iou_abs"]:
        bad.append(f"evaluator card vs CPU IoU {in_process['per_image_iou_max_abs_diff']}")
    if masked_nonzero:
        bad.append(f"{masked_nonzero} pruned entries are nonzero after the fine-tune")
    if sparsity_file["expansion"] != prune_reports["expansion"]["sparsity"]["global_sparsity"]:
        bad.append("expansion sparsity moved in the fine-tune")
    if abs(sparsity_file["magnitude"] - 0.3) > CE_TOL["sparsity_abs"]:
        bad.append(f"magnitude sparsity {sparsity_file['magnitude']}")
    for k, v in exported.items():
        bad += [f"export {k} CLI: {f}" for f in v["cli_faults"]]
        if v["cli_faults"]:
            bad.append(f"export {k} readings: card {v['card_readings']}, CPU "
                       f"{v['cpu_referee_readings']}, float64 referee {v['float64_referee']}")
        bad += [f"export {k} {g} float64: {r}" for g, r in v["float64_referee"].items()
                if not (r["float64_card_vs_cpu"] <= FLOAT64_AGREE
                        and r["export_error_float64"] < atol)]
        bad += [f"export {k}: {r}" for r in v["executor_card_vs_cpu"] if not r["pass"]]
    if agree_cpu < CE_TOL["served_agreement"] or agree_onnx < CE_TOL["served_agreement"]:
        bad.append(f"served pruned model: card vs CPU {agree_cpu}, vs ONNX {agree_onnx}")
    if bad:
        fail(f"compress_export: {bad}")
    _check_seg_launches("compress_export_served", launches)
    return launches


PROGRAM_ATOL = 1e-5          # the torch.export self-test's gate (export/torch_export.py)
PROGRAM_CLI_TOL = {"seg_fraction": 1e-4, "seg_confidence": 1e-5, "pose_px": 0.5,
                   "yolo_px": 0.02, "direct_rel": 1e-5}
YOLO_PX_TOL, YOLO_PROB_TOL = 2e-3, 1e-5   # export_yolo_torch.py's fp32 gate; probability rows


def program_fields(path: Path) -> tuple:
    """An export CLI's ``torch.export`` artifact, from its sidecar: the
    CLI's self-test on the card (below PROGRAM_ATOL), the trace-and-save
    seconds, MB. (The programs are timed where they are loaded and held
    against their models: ``program_clis``, ``yolo_program_devices``.)"""
    info = json.loads(Path(f"{path}.json").read_text())
    fields = {"file": path.name, "mb": info["bytes"] / 1e6,
              "export_seconds": info["export_seconds"], "device": info["device"],
              "self_test_max_diff": info["self_test_max_diff"],
              "self_test_pass": info["self_test_pass"]}
    ok = (info["self_test_pass"] and info["self_test_max_diff"] < PROGRAM_ATOL
          and info["device"].startswith("cuda"))
    return fields, [] if ok else [f"{path.name}: {info}"]


def yolo_rows_error(got, want) -> tuple:
    """max|got - want| on output0's pixel rows and on its probability rows."""
    import numpy as np

    n = want.shape[1]
    prob = [4] + [i for i in range(5, n) if (i - 5) % 3 == 2]
    px = [i for i in range(n) if i not in prob]
    return (float(np.abs(got[:, px] - want[:, px]).max()),
            float(np.abs(got[:, prob] - want[:, prob]).max()))


def program_clis(torch, seg_pkg: Path, seg_ck: Path, pose_pkg: Path, pose_ck: Path,
                 root: Path) -> tuple:
    """``seg_inference_torch.py`` and ``pose_inference_torch.py`` with
    ``--pt2`` (the dense seg package's model.pt2, the pose package's
    pose.pt2) against ``--checkpoint`` on the same checkpoints, float32,
    two synthetic samples each, in this process on the card under
    ``ieee_fp32()``: seg card fraction and confidence, pose corners within
    the served corner gate (a barely trained HRNet's heatmaps are flat, so
    the decode's argmax is held on the heatmaps below); and each program
    against its model directly on a probe: the logits / heatmaps within
    1e-5 of their largest value, the seg masks equal, and the ms per b1
    call of the program loaded on the card (its output copied to the
    host, as the runner returns it)."""
    import numpy as np

    import pose_inference_torch
    import seg_inference_torch
    from mtg_card_image_segmentation_tpu_torch.serving.artifact_backend import load_program
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax, hrnet_from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import ieee_fp32

    fields, bad = {}, []
    runs = {"seg": (seg_inference_torch, seg_pkg, seg_ck, ["model.compute_dtype=float32"]),
            "pose": (pose_inference_torch, pose_pkg, pose_ck, ["pose.compute_dtype=float32"])}
    for name, (mod, pkg, ck, sets) in runs.items():
        out = {}
        for src, args in (("pt2", ["--pt2", str(pkg)]), ("checkpoint", ["--checkpoint", str(ck)])):
            t0 = time.perf_counter()
            with ieee_fp32():
                r = mod.main([*args, "--synthetic", "2", "--set", *sets,
                              "--output-dir", str(root / f"program_{name}_{src}")])
            out[src] = {"source": Path(r["source"]).name, "seconds": time.perf_counter() - t0,
                        "results": r["results"]}
        pairs = list(zip(out["pt2"]["results"], out["checkpoint"]["results"]))
        if name == "seg":
            diff = {"card_fraction": max(abs(a["card_pixel_fraction"] - b["card_pixel_fraction"])
                                         for a, b in pairs),
                    "confidence": max(abs(a["mean_card_confidence"] - b["mean_card_confidence"])
                                      for a, b in pairs)}
            if not (diff["card_fraction"] <= PROGRAM_CLI_TOL["seg_fraction"]
                    and diff["confidence"] <= PROGRAM_CLI_TOL["seg_confidence"]):
                bad.append(f"seg --pt2 vs --checkpoint: {diff}")
        else:
            diff = {"corners_px": max(float(np.abs(np.subtract(a["corners_xy"],
                                                                b["corners_xy"])).max())
                                      for a, b in pairs)}
            if not diff["corners_px"] <= PROGRAM_CLI_TOL["pose_px"]:
                bad.append(f"pose --pt2 vs --checkpoint: {diff}")
        fields[name] = {**out, "pt2_vs_checkpoint": diff}
    # the programs against their models on a probe, on the card
    for name, pkg, ck, family in (("seg", seg_pkg, seg_ck, "seg"),
                                  ("pose", pose_pkg, pose_ck, "hrnet")):
        params, stats, _ = load_params(str(ck.parent), ck.name)
        if family == "seg":
            model, hw = from_flax(params, stats, dtype=torch.float32), DATA_HW
        else:
            model, hw = hrnet_from_flax(params, stats, POSE_HEATMAP_HW, dtype=torch.float32), POSE_HW
        x = np.random.default_rng(SEED + 12).standard_normal((1, 3, *hw)).astype(np.float32)
        fn, _ = load_program(str(pkg), family, "cuda")
        with ieee_fp32(), torch.inference_mode():
            got = fn(x)
            want = model.cuda()(torch.from_numpy(x.transpose(0, 2, 3, 1)).cuda())
            want = want.permute(0, 3, 1, 2).cpu().numpy()
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        xt = torch.from_numpy(x).cuda()
        row = {"program_vs_model_rel": rel,
               "program_ms_b1": median_ms(torch, lambda: fn(xt), 5, 2)}
        if family == "seg":
            row["mask_agreement"] = float((got.argmax(1) == want.argmax(1)).mean())
        fields[name]["direct"] = row
        if not rel <= PROGRAM_CLI_TOL["direct_rel"] or row.get("mask_agreement", 1.0) < 1.0:
            bad.append(f"{name} program vs model on the card: {row}")
    return fields, bad


def yolo_program_devices(torch, pkg: Path, ck: Path, root: Path) -> tuple:
    """The YOLO program across devices: the card-exported yolo.pt2 run on
    the CPU, and one exported on the CPU (its anchor grid's ``arange``
    nodes carry ``device=cpu``) run on the card through
    ``move_to_device_pass``; each against the folded float32 model on the
    same device (the card under ``ieee_fp32()``): pixel rows within the
    export CLI's 2e-3 px gate, probability rows within 1e-5."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
    from mtg_card_image_segmentation_tpu_torch.export.torch_export import (
        YoloOutput0,
        export_program,
    )
    from mtg_card_image_segmentation_tpu_torch.serving.artifact_backend import load_program
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import yolo_from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import ieee_fp32

    params, stats, _ = load_params(str(ck), "final_model")
    folded = fold_batch_norm(params, stats)
    s = YOLO_SIZE
    x = np.random.default_rng(SEED + 13).random((1, 3, s, s)).astype(np.float32)
    models = {dev: YoloOutput0(yolo_from_flax(folded, None, dtype=torch.float32).to(dev))
              for dev in ("cpu", "cuda")}

    def model_out(dev):
        with ieee_fp32(), torch.inference_mode():
            return models[dev](torch.from_numpy(x).to(dev)).cpu().numpy()

    cpu_path = root / "yolo_cpu.pt2"
    info = export_program(models["cpu"], (torch.zeros(1, 3, s, s),), str(cpu_path),
                          self_test=False)  # held below, on the card
    program = torch.export.load(str(cpu_path))
    node_devices = sorted({str(n.kwargs["device"]) for n in program.graph.nodes
                           if n.op == "call_function" and "device" in n.kwargs})
    fields, bad = {"cpu_export": {"mb": info["bytes"] / 1e6,
                                  "export_seconds": info["export_seconds"],
                                  "graph_node_devices": node_devices}}, []
    for name, path, dev in (("card_export_on_cpu", pkg / "yolo.pt2", "cpu"),
                            ("cpu_export_on_card", cpu_path, "cuda")):
        fn, _ = load_program(str(path), "yolo", dev)
        with ieee_fp32():
            got = fn(x)
        px, prob = yolo_rows_error(got, model_out(dev))
        row = {"px_max_abs": px, "prob_max_abs": prob}
        if dev == "cuda":
            xt = torch.from_numpy(x).cuda()
            row["program_ms_b1"] = median_ms(torch, lambda: fn(xt), 5, 2)
        fields[name] = row
        if not (px <= YOLO_PX_TOL and prob <= YOLO_PROB_TOL):
            bad.append(f"yolo program {name}: {row}")
    if node_devices != ["cpu"]:
        bad.append(f"the CPU-exported YOLO graph's node devices: {node_devices}")
    return fields, bad


POSE_GATE_B = 4             # the fp32 pose train step's batch, card vs CPU
POSE_B = 24                 # the pose config's batch (pose_default_config)
POSE_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-4, "batch_stats_abs": 1e-5,
            "fp32_grad_factor": 2.0, "served_px": 0.5, "served_bf16_factor": 2.0,
            "eval_rel": 1e-3}
POSE_ARTIFACTS = ("pose.onnx", "pose_fp16.onnx", "pose_int8.onnx", "pose_dynamic.onnx")


def pose_batch(torch, b: int, seed: int, device: str = "cpu"):
    """(images in [0,1], target heatmaps, corners) of ``b`` clean rendered
    scenes at POSE_HW, the training stream's kind, drawn on ``device``."""
    from mtg_card_image_segmentation_tpu_torch.data.pipeline import PoseSyntheticPipeline

    return PoseSyntheticPipeline(b, *POSE_HW, *POSE_HEATMAP_HW, augment=None, seed=seed,
                                 device=device).next_batch()


def pose_grads_float64(torch, weights, imgs, targets, device: str) -> tuple:
    """The pose MSE step's loss and gradients in float64 on ``device``
    (``training.loop.pose_grads_float64``), as Flax-layout leaves."""
    from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetPose
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import flatten_tree
    from mtg_card_image_segmentation_tpu_torch.training.loop import pose_grads_float64
    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        flax_to_state_dict,
        state_dict_to_flax,
    )

    model = HRNetPose(heatmap_height=POSE_HEATMAP_HW[0], heatmap_width=POSE_HEATMAP_HW[1],
                      dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(*weights), strict=True)
    loss, grads = pose_grads_float64(model.to(device), imgs.to(device), targets.to(device))
    return loss, flatten_tree(state_dict_to_flax(grads)[0])


def pose_train_gate_fp32(torch, card) -> dict:
    """One pose train step of the full HRNet at 480x640 b4 on the card and
    on the CPU from the same seeded weights (BN statistics off init) and the
    same rendered batch, TF32 off. In float32, through the train step: the
    loss, every BN's running statistics (the head's deconv_bn0/1 included)
    and the dead gradients (the last stage's fusion convs that feed nothing:
    zero on both). The gradients are held in float64, the same step on each
    device, every tensor against its largest entry: at this size the
    float32 gradients of either device lie up to a few percent of a
    tensor's largest entry from the float64 ones (a train-mode BatchNorm's
    backward cancels, and ReLUs whose input rounds to the other side of 0
    flip), so no two float32 implementations meet 1e-4 there. So the card's
    fp32 gradients are held by their distance from the CPU's float64 ones:
    the worst tensor's (largest entry's share) at most twice the CPU fp32
    step's own (``fp32_grad_factor``); a fault of the card's backward (TF32
    left on, a wrong kernel) misses by far more than the CPU's rounding."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig
    from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetPose
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import flatten_tree
    from mtg_card_image_segmentation_tpu_torch.training.loop import make_pose_train_step
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        flax_to_state_dict,
        init_hrnet_flax_like,
        state_dict_to_flax,
    )

    weights = init_hrnet_flax_like(SEED)
    imgs, targets, _ = pose_batch(torch, POSE_GATE_B, SEED + 70)
    sgd = dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.05)
    out = {}
    for dev in ("cpu", "cuda"):
        model = HRNetPose(heatmap_height=POSE_HEATMAP_HW[0], heatmap_width=POSE_HEATMAP_HW[1],
                          dtype=torch.float32)
        model.load_state_dict(flax_to_state_dict(*weights), strict=True)
        opt_def, _ = create_optimizer(OptimizerConfig(**sgd), 1, 10)
        state = create_seg_state(model.train(), opt_def, torch.device(dev))
        t0 = time.perf_counter()
        _, stats = make_pose_train_step()(state, imgs.to(dev), targets.to(dev))
        loss = float(stats["loss"])
        grads = state_dict_to_flax({n: p.grad for n, p in state.model.named_parameters()})[0]
        out[dev] = (loss, flatten_tree(grads), flatten_tree(state.variables()["batch_stats"]),
                    time.perf_counter() - t0)
    (l_cpu, g_cpu, s_cpu, t_cpu), (l_gpu, g_gpu, s_gpu, t_gpu) = out["cpu"], out["cuda"]
    f64 = {dev: pose_grads_float64(torch, weights, imgs, targets, dev)
           for dev in ("cpu", "cuda")}
    (l64_cpu, g64_cpu), (l64_gpu, g64_gpu) = f64["cpu"], f64["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    dead = sorted(k for k, v in g64_cpu.items() if not np.abs(v).any())

    def rel(a, b):
        return {k: float(np.abs(a[k] - v).max() / np.abs(v).max())
                for k, v in b.items() if k not in dead}

    ratios = rel(g64_gpu, g64_cpu)
    worst = max(ratios, key=ratios.get)
    dead_card = max(float(max(np.abs(g_gpu[k]).max(), np.abs(g64_gpu[k]).max()))
                    for k in dead) if dead else 0.0
    stats_err = {k: float(np.abs(s_gpu[k] - v).max()) for k, v in s_cpu.items()}
    worst_s = max(stats_err, key=stats_err.get)
    fp32_vs_f64 = {}
    for name, g in (("card", g_gpu), ("cpu", g_cpu)):
        e = rel(g, g64_cpu)
        w = max(e, key=e.get)
        norms = {k: float(np.linalg.norm(g[k] - v) / np.linalg.norm(v))
                 for k, v in g64_cpu.items() if k not in dead}
        wn = max(norms, key=norms.get)
        fp32_vs_f64[name] = {"worst_tensor": w, "worst_rel_err": e[w],
                             "worst_l2_tensor": wn, "worst_rel_l2": norms[wn],
                             "tensors_over_grad_rel": sum(v > POSE_TOL["grad_rel"]
                                                          for v in e.values())}
    fp32_factor = fp32_vs_f64["card"]["worst_rel_err"] / fp32_vs_f64["cpu"]["worst_rel_err"]
    r = {"phase": "pose_train_fp32_card_vs_cpu", "size": list(POSE_HW), "batch": POSE_GATE_B,
         "loss_cpu": l_cpu, "loss_card": l_gpu, "loss_rel_err": loss_rel,
         "batch_stats_tensors": len(s_cpu), "batch_stats_max_abs_err": stats_err[worst_s],
         "batch_stats_worst_tensor": worst_s,
         "head_deconv_bn_max_abs_err": max(v for k, v in stats_err.items() if "deconv_bn" in k),
         "grad_tensors": len(g64_cpu), "dead_grad_tensors": len(dead),
         "dead_grad_card_max": dead_card,
         "float64_loss_rel_err": abs(l64_gpu - l64_cpu) / abs(l64_cpu),
         "float64_grad_worst_rel_err": ratios[worst], "float64_grad_worst_tensor": worst,
         "float64_grad_rel_err_head_deconv": {k: ratios[k] for k in ratios if "deconv" in k},
         "fp32_grad_vs_cpu_float64": fp32_vs_f64, "fp32_grad_card_over_cpu": fp32_factor,
         "step_seconds": {"cpu": t_cpu, "card_first_call": t_gpu}, "tolerance": POSE_TOL,
         "card": card["name"], "nvidia_smi": card["nvidia_smi"]}
    emit(r)
    bad = []
    if not loss_rel <= POSE_TOL["loss_rel"]:
        bad.append(f"loss card {l_gpu} vs CPU {l_cpu}")
    if not stats_err[worst_s] <= POSE_TOL["batch_stats_abs"]:
        bad.append(f"BN statistics: {worst_s} {stats_err[worst_s]}")
    if not any("deconv_bn" in k for k in s_cpu):
        bad.append("the head's deconv BatchNorms are missing from the statistics")
    if not ratios[worst] <= POSE_TOL["grad_rel"] or dead_card != 0.0:
        bad.append(f"float64 gradients: {worst} {ratios[worst]}, dead {dead_card}")
    if not fp32_factor <= POSE_TOL["fp32_grad_factor"]:
        bad.append(f"fp32 gradients: the card's {fp32_vs_f64['card']} from float64, "
                   f"the CPU's {fp32_vs_f64['cpu']}")
    if bad:
        fail(f"pose fp32 train step card vs CPU: {bad}")
    return r


def pose_train_cli(torch, card, root: Path) -> tuple:
    """``train_pose_torch.py`` at the pose config (480x640 b24, bf16, AdamW
    1e-3, augmented stream) for 2 epochs x 8 steps, then ``--resume`` for a
    third epoch in a second process; six validation and four recalibration
    batches per epoch. Returns (checkpoint dir, the line's fields)."""
    import math

    ck = root / "ckpt_pose"
    sets = ["--set", "train.steps_per_epoch=8", "train.log_every_steps=8",
            f"train.checkpoint_dir={ck}", f"train.log_dir={root / 'logs_pose'}"]
    runs = [_cli([*sets, "train.num_epochs=2"], "pose_train", root, "train_pose_torch.py"),
            _cli(["--resume", *sets, "train.num_epochs=3"], "pose_resume", root,
                 "train_pose_torch.py")]
    hist = json.loads((ck / "history.json").read_text())
    logs = (root / "pose_train.log").read_text() + (root / "pose_resume.log").read_text()
    epoch_ms = runs[0]["logged_ms_per_step"] + runs[1]["logged_ms_per_step"]
    fields = {
        "runs": [{k: v for k, v in r.items() if k != "log"} for r in runs],
        # the first epoch of each process pays its warm-up
        "ms_per_step_by_epoch": epoch_ms,
        "steady_ms_per_step": epoch_ms[1],
        "steady_img_per_s": POSE_B * 1e3 / epoch_ms[1],
        "lr_scale_logged": [float(x) for x in re.findall(r"lr_scale=([\d.]+)", logs)],
        "resumed": [ln.split("] ", 1)[-1] for ln in logs.splitlines() if "Resumed" in ln],
        "history": hist}
    bad = []
    if any(r["device"] is None or not r["device"].startswith("cuda") for r in runs):
        bad.append(f"ran off the card: {[r['device'] for r in runs]}")
    if len(hist.get("val_loss", [])) != 3 or len(epoch_ms) != 3:
        bad.append(f"history of {len(hist.get('val_loss', []))} epochs, {len(epoch_ms)} logged")
    if not all(math.isfinite(x) for k in ("train_loss", "val_loss") for x in hist.get(k, [])):
        bad.append(f"losses not finite: {hist.get('train_loss')}, {hist.get('val_loss')}")
    if not fields["resumed"]:
        bad.append("the second process did not resume")
    if bad:
        fail(f"pose train CLI: {bad}")
    return ck, fields


def pose_served(torch, ck: Path) -> tuple:
    """The trained ``final_model`` served through ``PosePredictor`` at b24
    in bf16 (the normalize kernel) on its own rendered images, with the
    kernel launches of that call: outputs finite and in the image. Card vs
    CPU on 8 of them with the float32 predictor (the kernel's float32
    instance): the validity (conf >= 0.3) and, where both sides find the
    corner, its position. The bf16 predictor that users are served is held
    in heatmap space: its card heatmaps may lie no further from the CPU's
    float32 heatmaps than twice the CPU bf16 predictor's do
    (``served_bf16_factor``). Its decoded corners are reported, not gated:
    the predictor normalizes with the ImageNet statistics, as the JAX
    predictor does, while the pose model trains on /255 inputs (a quirk of
    the reference, ROADMAP Queue C), so a short run's heatmaps on served
    inputs are flat and bf16 rounding moves their peaks between far
    apart pixels on either device."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import PosePredictor

    def served(**kw):
        return PosePredictor.from_checkpoint(str(ck), "final_model", *POSE_HW,
                                             heatmap_hw=POSE_HEATMAP_HW, **kw)

    pred = served()
    imgs01, _, corners = pose_batch(torch, POSE_B, SEED + 71, "cuda")
    u8 = (imgs01 * 255).round().clamp(0, 255).to(torch.uint8)
    pred.predict(u8)
    torch.cuda.synchronize()
    _build.reset_launches()
    px, conf = pred.predict(u8)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    ms = median_ms(torch, lambda: pred.predict(u8), 5, 1)
    n, thr = 8, pred.threshold

    def pair(card_out, cpu_out):
        (p_card, c_card), (p_cpu, c_cpu) = card_out, cpu_out
        v_card, v_cpu = c_card[:n].cpu() >= thr, c_cpu >= thr
        both = v_card & v_cpu
        d = (p_card[:n].cpu() - p_cpu).norm(dim=-1)
        return {"valid_card": int(v_card.sum()), "valid_cpu": int(v_cpu.sum()),
                "validity_disagreements": int((v_card != v_cpu).sum()),
                "conf_max_abs_diff": float((c_card[:n].cpu() - c_cpu).abs().max()),
                "both_valid": int(both.sum()),
                "px_max_dist_where_both_valid": float(d[both].max()) if both.any() else None}

    host_bf16, host_fp32 = served(device="cpu"), served(dtype=torch.float32, device="cpu")
    hm_ref = host_fp32.heatmaps(u8[:n].cpu())
    hm_cpu = host_bf16.heatmaps(u8[:n].cpu())
    bf16 = pair((px, conf), host_bf16.decode(hm_cpu))
    fp32 = pair(served(dtype=torch.float32).predict(u8[:n]), host_fp32.decode(hm_ref))
    bf16["heatmap_max_abs_vs_cpu_float32"] = {
        "card": float((pred.heatmaps(u8[:n]).float().cpu() - hm_ref).abs().max()),
        "cpu": float((hm_cpu.float() - hm_ref).abs().max()),
        "heatmap_max_abs": float(hm_ref.abs().max())}
    fields = {"batch": POSE_B, "launches": launches, "predict_ms_b24": ms,
              "img_per_s": POSE_B * 1e3 / ms, "cpu_images": n,
              "float32_card_vs_cpu": fp32, "bf16_card_vs_cpu": bf16,
              "mean_error_px_vs_render": float((px - corners).norm(dim=-1).mean())}
    h, w = POSE_HW
    bad = []
    if launches.get("fused_normalize", 0) <= 0:
        bad.append(f"no fused_normalize launch: {launches}")
    if not (bool(torch.isfinite(px).all()) and bool(torch.isfinite(conf).all())):
        bad.append("outputs not finite")
    if float(px.min()) < 0 or float(px[..., 0].max()) > w - 1 or float(px[..., 1].max()) > h - 1:
        bad.append("corners outside the image")
    if fp32["validity_disagreements"]:
        bad.append(f"float32 validity differs on {fp32['validity_disagreements']} corners")
    if fp32["both_valid"] and fp32["px_max_dist_where_both_valid"] > POSE_TOL["served_px"]:
        bad.append(f"float32 corners {fp32['px_max_dist_where_both_valid']} px apart")
    d = bf16["heatmap_max_abs_vs_cpu_float32"]
    if not d["card"] <= POSE_TOL["served_bf16_factor"] * d["cpu"]:
        bad.append(f"bf16 heatmaps from the CPU's float32: card {d['card']}, CPU {d['cpu']}")
    return launches, fields, bad


def pose_eval_card_vs_cpu(torch, ck: Path) -> tuple:
    """``PoseEvaluator`` (fp32 model, ``output_dir=None``) on the card and
    on the CPU over the same two held-out batches of 8 (the evaluate CLI's
    seeds 5,000,000 + i, rendered on the card): accuracies, mean and median
    error to 1e-3 relative; and the evaluation's ms per b24 batch with the
    bf16 model."""
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch
    from mtg_card_image_segmentation_tpu_torch.evaluation import PoseEvaluator
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import hrnet_from_flax

    params, stats, _ = load_params(str(ck), "final_model")

    def held_out(i, b):
        s = synthetic_batch(torch.Generator(device="cuda").manual_seed(5_000_000 + i), b,
                            *POSE_HW, 0.0, keep_in_frame=True)
        return s.image, s.corners

    batches = [held_out(i, 8) for i in range(2)]
    reps = {}
    for dev in ("cuda", "cpu"):
        model = hrnet_from_flax(params, stats, POSE_HEATMAP_HW, dtype=torch.float32).to(dev)
        reps[dev] = PoseEvaluator(model, POSE_HW).evaluate(
            [(x.to(dev), c.to(dev)) for x, c in batches], output_dir=None, worst_k=0)
    keys = [k for k in reps["cpu"] if k.startswith("accuracy_")] + [
        "mean_error_px", "median_error_px"]
    rel = {k: abs(reps["cuda"][k] - reps["cpu"][k]) / max(abs(reps["cpu"][k]), 1e-12)
           if reps["cuda"][k] != reps["cpu"][k] else 0.0 for k in keys}
    bf16 = hrnet_from_flax(params, stats, POSE_HEATMAP_HW, dtype=torch.bfloat16).to("cuda")
    ev, big = PoseEvaluator(bf16, POSE_HW), [held_out(2, POSE_B)]
    ms = median_ms(torch, lambda: ev.evaluate(big, worst_k=0), 5, 2)
    fields = {"images": 16, "card": {k: reps["cuda"][k] for k in keys},
              "cpu": {k: reps["cpu"][k] for k in keys}, "rel_err": rel,
              "detection_rate": [reps[d]["detection_rate"] for d in ("cuda", "cpu")],
              "eval_ms_per_batch_bf16_b24": ms}
    bad = [f"evaluator {k}: card {reps['cuda'][k]} CPU {reps['cpu'][k]}"
           for k, v in rel.items() if v > POSE_TOL["eval_rel"]]
    return fields, bad


def pose_export(torch, root: Path, ck: Path) -> tuple:
    """``export_pose_torch.py`` of the trained checkpoint: the CLI gates its
    package on the card (fp32 and both dynamic gates must pass; fp16 and
    int8 may miss, as on a barely trained tree they do in both packages,
    ``tests/test_torch_pose_export.py``; the exit code must agree); then
    every artifact run by the executor on the card and on the CPU on the
    CLI's probe kind ([0,1] noise, b1; the dynamic graph also at b4): the
    float32 graphs within 1e-5 of the largest heatmap value, the fp16 graph
    no further from the fp32 model on the card than twice the CPU's."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import run_model
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import hrnet_from_flax

    out_dir = root / "export_pose"
    run = _cli(["--checkpoint", str(ck / "final_model"), "--output-dir", str(out_dir)],
               "export_pose", root, "export_pose_torch.py", exits=(0, 1))
    log = (root / "export_pose.log").read_text()
    verdicts = export_gate_verdicts(log)
    faults = export_gate_faults(run, verdicts, frozenset({"fp16", "int8"}))
    h, w = POSE_HW
    x1 = np.random.default_rng(0).random((1, 3, h, w)).astype(np.float32)
    x4 = np.random.default_rng(1).random((4, 3, h, w)).astype(np.float32)
    params, stats, _ = load_params(str(ck), "final_model")
    with torch.inference_mode():
        ref = hrnet_from_flax(params, stats, POSE_HEATMAP_HW, dtype=torch.float32)(
            torch.from_numpy(np.ascontiguousarray(x1.transpose(0, 2, 3, 1)))).numpy()
    ref = ref.transpose(0, 3, 1, 2)
    rows = []
    for art, x in (("pose.onnx", x1), ("pose_dynamic.onnx", x1), ("pose_dynamic.onnx", x4),
                   ("pose_int8.onnx", x1), ("pose_fp16.onnx", x1)):
        graph = op.Model.load(str(out_dir / art))
        card_out, host = (run_model(graph, {"input": x}, dev)["heatmaps"]
                          for dev in ("cuda", "cpu"))
        row = {"artifact": art, "batch": x.shape[0],
               "finite": bool(np.isfinite(card_out).all()),
               "card_vs_cpu_max_abs": float(np.abs(card_out - host).max()),
               "heatmap_max_abs": float(np.abs(host).max())}
        if art == "pose_fp16.onnx":
            row["card_vs_fp32_model"] = float(np.abs(card_out - ref).max())
            row["cpu_vs_fp32_model"] = float(np.abs(host - ref).max())
            row["pass"] = row["finite"] and (row["card_vs_fp32_model"]
                                             <= 2 * row["cpu_vs_fp32_model"])
        else:
            row["pass"] = row["finite"] and (row["card_vs_cpu_max_abs"]
                                             <= 1e-5 * row["heatmap_max_abs"])
        rows.append(row)
    program, bad_program = program_fields(out_dir / "pose.pt2")
    fields = {"cli_exit": run["exit"], "cli_wall_seconds": run["wall_seconds"],
              "cli_gates": [ln for ln in log.splitlines() if re.match(r"\S+ parity", ln)],
              "cli_verdicts": verdicts, "may_miss": ["fp16", "int8"], "cli_faults": faults,
              "pose_info_parity": (json.loads((out_dir / "pose_info.json").read_text())["parity"]
                                   if (out_dir / "pose_info.json").exists() else None),
              "sizes_mb": {a: (out_dir / a).stat().st_size / 1e6 for a in POSE_ARTIFACTS},
              "executor_card_vs_cpu": rows, "torch_export": program}
    bad = [f"export CLI: {f}" for f in faults] + [f"executor: {r}" for r in rows
                                                   if not r["pass"]] + bad_program
    if run["device"] is None or not run["device"].startswith("cuda"):
        bad.append(f"export ran off the card: {run['device']}")
    return out_dir, fields, bad


def inference_clis(pose_pkg: Path, pose_ck: Path, seg_pkg: Path, seg_ck: Path,
                   root: Path) -> tuple:
    """``pose_inference_torch.py`` and ``seg_inference_torch.py`` through
    ``main(argv)`` in this process, on the card: each on a package
    directory, where the ladder must choose the int8 rung and fall past
    nothing, and on a checkpoint, two synthetic samples each."""
    import math

    import pose_inference_torch
    import seg_inference_torch

    calls = {
        "pose_onnx": (pose_inference_torch, ["--onnx", str(pose_pkg)], "pose_int8.onnx"),
        "pose_checkpoint": (pose_inference_torch, ["--checkpoint", str(pose_ck)], None),
        "seg_onnx": (seg_inference_torch, ["--onnx", str(seg_pkg)], "model_int8.onnx"),
        "seg_checkpoint": (seg_inference_torch, ["--checkpoint", str(seg_ck)], None)}
    fields, bad = {}, []
    for name, (mod, args, rung) in calls.items():
        t0 = time.perf_counter()
        r = mod.main([*args, "--synthetic", "2", "--output-dir", str(root / f"inference_{name}")])
        fields[name] = {"source": Path(r["source"]).name,
                        "ladder_fell_past": r["ladder_fell_past"],
                        "seconds": time.perf_counter() - t0, "results": r["results"]}
        if rung is not None and (fields[name]["source"] != rung or r["ladder_fell_past"]):
            bad.append(f"{name}: chose {fields[name]['source']}, fell past "
                       f"{r['ladder_fell_past']}")
        for res in r["results"]:
            nums = res.get("corners_xy", [[res.get("card_pixel_fraction", 0.0)]])
            if not all(math.isfinite(v) for row in nums for v in row):
                bad.append(f"{name}: not finite {res}")
    return fields, bad


def pose_train_numbers(torch, card) -> dict:
    """The pose train step at the config's 480x640 b24 (bf16, AdamW): ms,
    img/s and peak memory (median of 10 steps after 3), and a
    ``torch.profiler`` pass of 3 steps: kernel time by class against the
    device's idle share."""
    from mtg_card_image_segmentation_tpu_torch.config import PoseModelConfig
    from mtg_card_image_segmentation_tpu_torch.models import registry
    from mtg_card_image_segmentation_tpu_torch.training.loop import make_pose_train_step
    from mtg_card_image_segmentation_tpu_torch.training.optim import OptimizerDef
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_defaults

    model = init_flax_defaults(registry.pose_from_config(PoseModelConfig()), SEED)
    state = create_seg_state(model, OptimizerDef("adamw", 1e-4, 0.9, None, lambda c: 1e-3),
                             torch.device("cuda"))
    imgs, targets, _ = pose_batch(torch, POSE_B, SEED + 72, "cuda")
    step = make_pose_train_step()
    for _ in range(3):
        step(state, imgs, targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(torch, lambda: step(state, imgs, targets), 10, 0)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_calls(torch, lambda: step(state, imgs, targets), 3)
    emit({"phase": "profile", "path": "pose_train_step", "batch": POSE_B,
          "size": list(POSE_HW), **prof, "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    return {"step_ms": ms, "img_per_s": POSE_B * 1e3 / ms, "peak_mem_bytes": peak,
            "profile_kernel_ms_per_step": prof["kernel_ms_per_call"],
            "profile_device_idle_share": prof["device_idle_share"]}


def phase_pose_pipeline(torch, card, root: Path, seg_ck: Path, seg_pkg: Path,
                        seg_dense_pkg: Path) -> dict:
    """HRNet pose training, evaluation, export and the inference CLIs on the
    card at the pose config (480x640, 120x160 heatmaps, b24, bf16): one
    train step card vs CPU (``pose_train_fp32_card_vs_cpu``),
    ``train_pose_torch.py`` for 2 epochs x 8 steps and a resumed third, the
    trained checkpoint served through kernel 4, ``PoseEvaluator`` card vs
    CPU, ``export_pose_torch.py`` with every artifact card vs CPU, the pose
    and seg inference CLIs (``seg_ck``/``seg_pkg``: ``train_cli``'s
    checkpoint and ``compress_export``'s slim package), both with ``--pt2``
    against ``--checkpoint`` (``seg_dense_pkg``: the dense package of
    ``seg_ck``; ``program_clis``), and the train step's numbers and profile.
    Returns the served call's kernel launches."""
    t_start = time.perf_counter()
    pose_train_gate_fp32(torch, card)
    ck, train = pose_train_cli(torch, card, root)
    launches, served, bad = pose_served(torch, ck)
    evaluated, bad_eval = pose_eval_card_vs_cpu(torch, ck)
    pose_pkg, exported, bad_export = pose_export(torch, root, ck)
    clis, bad_cli = inference_clis(pose_pkg, ck / "final_model", seg_pkg, seg_ck, root)
    programs, bad_programs = program_clis(torch, seg_dense_pkg, seg_ck, pose_pkg,
                                          ck / "final_model", root)
    numbers = pose_train_numbers(torch, card)
    bad += bad_eval + bad_export + bad_cli + bad_programs
    emit({"phase": "pose_pipeline", "size": list(POSE_HW), "heatmap": list(POSE_HEATMAP_HW),
          "batch": POSE_B, "train_cli": train, "served": served,
          "evaluator_card_vs_cpu": evaluated, "export": exported, "inference_clis": clis,
          "program_clis": programs,
          "train_step": numbers, "tolerance": POSE_TOL,
          "seconds": time.perf_counter() - t_start,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if bad:
        fail(f"pose_pipeline: {bad}")
    return launches


YOLO_GATE_B = 4             # the fp32 YOLO train step's batch, card vs CPU
YOLO_B = 32                 # the default config's batch (train_yolo_torch.py)
YOLO_CPU_IMAGES = 4         # served images held card vs CPU
YOLO_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-4, "batch_stats_float64": 1e-10,
            "batch_stats_factor": 2.0, "zero_grad": 1e-10,
            "fp32_grad_factor": 2.0, "served_px": 0.5, "served_conf": 1e-5,
            "served_bf16_factor": 2.0, "eval_rel": 1e-3, "executor_rel": 1e-5,
            "fp16_factor": 2.0}
YOLO_ARTIFACTS = ("yolo.onnx", "yolo_fp16.onnx", "yolo_int8.onnx", "yolo_dynamic.onnx")


def yolo_batch(torch, b: int, seed: int, device: str = "cpu"):
    """(images in [0,1], (B, 4, 2) corner pixels) of ``b`` clean rendered
    scenes at 640x640 with the card in frame, drawn on ``device``."""
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch

    gen = torch.Generator(device=device).manual_seed(seed)
    s = synthetic_batch(gen, b, YOLO_SIZE, YOLO_SIZE, 0.0, keep_in_frame=True)
    return s.image, s.corners


def yolo_train_gate_fp32(torch, card) -> dict:
    """One YOLO train step of the full YOLO12n-pose at 640x640 b4 on the
    card and on the CPU from the same seeded weights (BN statistics off
    init) and the same rendered batch, TF32 off; ``pose_train_gate_fp32``'s
    rules. The loss in float32, through the train step. The gradients and
    every BN's running statistics (Flax momentum 0.97) in float64, the same
    step on each device: gradients against each tensor's largest entry
    (the tensors whose float64 gradient is zero in exact arithmetic, below
    1e-12 of the largest gradient on the CPU: BN biases whose shift reaches
    a train-mode BN through 1x1 convs only, and a branch without positives,
    are held below ``zero_grad`` of the largest gradient instead),
    statistics against 1 + each tensor's largest entry. The card's fp32
    gradients and statistics are held by their distance from the CPU's
    float64 ones: at most twice the CPU fp32 step's own. (At 640x640 b4 the
    fp32 statistics of the deepest blocks part card vs CPU by 1.15e-5 of 1
    + their largest entry, the rounding of some 40 layers of fp32 forward
    on either device; the line reports that distance.)"""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig
    from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import YOLO12Pose
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import flatten_tree
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.training.yolo_loss import (
        make_yolo_train_step,
        yolo_grads_float64,
    )
    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        flax_to_state_dict,
        init_yolo_flax_like,
        state_dict_to_flax,
    )

    weights = init_yolo_flax_like(SEED)
    imgs, corners = yolo_batch(torch, YOLO_GATE_B, SEED + 80)
    sgd = dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.05)

    def model():
        m = YOLO12Pose(dtype=torch.float32)
        m.load_state_dict(flax_to_state_dict(*weights), strict=True)
        return m.train()

    out, f64 = {}, {}
    for dev in ("cpu", "cuda"):
        opt_def, _ = create_optimizer(OptimizerConfig(**sgd), 1, 10)
        state = create_seg_state(model(), opt_def, torch.device(dev))
        t0 = time.perf_counter()
        _, parts = make_yolo_train_step()(state, imgs.to(dev), corners.to(dev))
        loss = float(parts["loss"])
        grads = state_dict_to_flax({n: p.grad for n, p in state.model.named_parameters()})[0]
        out[dev] = (loss, flatten_tree(grads), flatten_tree(state.variables()["batch_stats"]),
                    time.perf_counter() - t0, {k: float(v) for k, v in parts.items()})
        loss64, g64, ref = yolo_grads_float64(model().to(dev), imgs.to(dev), corners.to(dev))
        f64[dev] = (loss64, flatten_tree(state_dict_to_flax(g64)[0]),
                    flatten_tree(state_dict_to_flax(ref.state_dict())[1]))
    (l_cpu, g_cpu, s_cpu, t_cpu, p_cpu), (l_gpu, g_gpu, s_gpu, t_gpu, p_gpu) = (
        out["cpu"], out["cuda"])
    (l64_cpu, g64_cpu, s64_cpu), (l64_gpu, g64_gpu, s64_gpu) = f64["cpu"], f64["cuda"]
    gmax = max(float(np.abs(v).max()) for v in g64_cpu.values())
    zero = sorted(k for k, v in g64_cpu.items() if np.abs(v).max() <= 1e-12 * gmax)

    def rel(a):
        return {k: float(np.abs(a[k] - v).max() / np.abs(v).max())
                for k, v in g64_cpu.items() if k not in zero}

    ratios = rel(g64_gpu)
    worst = max(ratios, key=ratios.get)
    zero_card = max((float(np.abs(g64_gpu[k]).max()) / gmax for k in zero), default=0.0)
    def stats_rel(a, b):
        e = {k: float(np.abs(a[k] - v).max() / (1.0 + np.abs(v).max())) for k, v in b.items()}
        w = max(e, key=e.get)
        return {"worst_tensor": w, "worst_err": e[w]}

    stats = {"fp32_card_vs_cpu": stats_rel(s_gpu, s_cpu),
             "float64_card_vs_cpu": stats_rel(s64_gpu, s64_cpu),
             "fp32_card_vs_cpu_float64": stats_rel(s_gpu, s64_cpu),
             "fp32_cpu_vs_cpu_float64": stats_rel(s_cpu, s64_cpu)}
    stats_factor = (stats["fp32_card_vs_cpu_float64"]["worst_err"]
                    / stats["fp32_cpu_vs_cpu_float64"]["worst_err"])
    fp32_vs_f64 = {}
    for name, g in (("card", g_gpu), ("cpu", g_cpu)):
        e = rel(g)
        w = max(e, key=e.get)
        fp32_vs_f64[name] = {"worst_tensor": w, "worst_rel_err": e[w],
                             "tensors_over_grad_rel": sum(v > YOLO_TOL["grad_rel"]
                                                          for v in e.values())}
    fp32_factor = fp32_vs_f64["card"]["worst_rel_err"] / fp32_vs_f64["cpu"]["worst_rel_err"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    r = {"phase": "yolo_train_fp32_card_vs_cpu", "size": [YOLO_SIZE, YOLO_SIZE],
         "batch": YOLO_GATE_B, "loss_cpu": l_cpu, "loss_card": l_gpu, "loss_rel_err": loss_rel,
         "parts_cpu": p_cpu, "parts_card": p_gpu,
         "batch_stats_tensors": len(s_cpu), "batch_stats_over_1_plus_max": stats,
         "batch_stats_fp32_card_over_cpu": stats_factor,
         "grad_tensors": len(g64_cpu), "zero_grad_tensors": len(zero),
         "zero_grad_card_max_over_gmax": zero_card,
         "float64_loss_rel_err": abs(l64_gpu - l64_cpu) / abs(l64_cpu),
         "float64_grad_worst_rel_err": ratios[worst], "float64_grad_worst_tensor": worst,
         "fp32_grad_vs_cpu_float64": fp32_vs_f64, "fp32_grad_card_over_cpu": fp32_factor,
         "step_seconds": {"cpu": t_cpu, "card_first_call": t_gpu}, "tolerance": YOLO_TOL,
         "card": card["name"], "nvidia_smi": card["nvidia_smi"]}
    emit(r)
    bad = []
    if not loss_rel <= YOLO_TOL["loss_rel"]:
        bad.append(f"loss card {l_gpu} vs CPU {l_cpu}")
    if (len(s_cpu) != 238 or not stats_factor <= YOLO_TOL["batch_stats_factor"]
            or not stats["float64_card_vs_cpu"]["worst_err"] <= YOLO_TOL["batch_stats_float64"]):
        bad.append(f"BN statistics ({len(s_cpu)} tensors): {stats}")
    if not ratios[worst] <= YOLO_TOL["grad_rel"] or not zero_card <= YOLO_TOL["zero_grad"]:
        bad.append(f"float64 gradients: {worst} {ratios[worst]}, zero tensors {zero_card}")
    if not fp32_factor <= YOLO_TOL["fp32_grad_factor"]:
        bad.append(f"fp32 gradients: the card's {fp32_vs_f64['card']} from float64, "
                   f"the CPU's {fp32_vs_f64['cpu']}")
    if bad:
        fail(f"yolo fp32 train step card vs CPU: {bad}")
    return r


def yolo_train_cli(torch, card, root: Path) -> tuple:
    """``train_yolo_torch.py`` at its default config (640x640 b32, bf16,
    AdamW with the cosine schedule, augmented renders) for 2 epochs x 8
    steps, then ``--resume`` for a third epoch in a second process; 4 clean
    eval batches per epoch. Returns (checkpoint dir, the line's fields)."""
    import math

    ck = root / "ckpt_yolo"
    sets = ["--set", "train.steps_per_epoch=8", "train.log_every_steps=8",
            f"train.checkpoint_dir={ck}", f"train.log_dir={root / 'logs_yolo'}"]
    runs = [_cli([*sets, "train.num_epochs=2"], "yolo_train", root, "train_yolo_torch.py"),
            _cli(["--resume", *sets, "train.num_epochs=3"], "yolo_resume", root,
                 "train_yolo_torch.py")]
    hist = json.loads((ck / "history.json").read_text())
    logs = (root / "yolo_train.log").read_text() + (root / "yolo_resume.log").read_text()
    epoch_ms = runs[0]["logged_ms_per_step"] + runs[1]["logged_ms_per_step"]
    fields = {
        "runs": [{k: v for k, v in r.items() if k != "log"} for r in runs],
        # the first epoch of each process pays its warm-up
        "ms_per_step_by_epoch": epoch_ms,
        "steady_ms_per_step": epoch_ms[1],
        "steady_img_per_s": YOLO_B * 1e3 / epoch_ms[1],
        "resumed": [ln.split("] ", 1)[-1] for ln in logs.splitlines() if "Resumed" in ln],
        "history": hist}
    bad = []
    if any(r["device"] is None or not r["device"].startswith("cuda") for r in runs):
        bad.append(f"ran off the card: {[r['device'] for r in runs]}")
    n = len(hist.get("val_mean_corner_distance", []))
    if n != 3 or len(epoch_ms) != 3:
        bad.append(f"history of {n} epochs, {len(epoch_ms)} logged")
    if not all(math.isfinite(x) for k in ("train_loss", "val_mean_corner_distance")
               for x in hist.get(k, [])):
        bad.append(f"not finite: {hist.get('train_loss')}, {hist.get('val_mean_corner_distance')}")
    if not fields["resumed"]:
        bad.append("the second process did not resume")
    if bad:
        fail(f"yolo train CLI: {bad}")
    return ck, fields


def yolo_served(torch, ck: Path) -> tuple:
    """The trained ``final_model`` served through ``YoloCornerPredictor`` at
    b32 in bf16 on its own rendered images (uint8), with the hand-written
    kernel launches of that call (the YOLO path runs none: it preprocesses
    with one torch /255 pass, as the reference does). Card vs CPU on
    YOLO_CPU_IMAGES of them: the float32 predictor's confidences within
    ``served_conf``, its validity (conf >= 0.25) and, where both sides find
    the corner, its position within ``served_px`` (a short run's
    confidences may all lie below 0.25: the distance over all corners is
    reported); the bf16 predictor that users are served in level-output
    space: its card levels no further from the CPU's float32 levels than
    twice the CPU bf16 predictor's."""
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import (
        YoloCornerPredictor,
    )

    def served(**kw):
        return YoloCornerPredictor.from_checkpoint(str(ck), "final_model", YOLO_SIZE, **kw)

    pred = served()
    imgs01, corners = yolo_batch(torch, YOLO_B, SEED + 81, "cuda")
    u8 = (imgs01 * 255).round().clamp(0, 255).to(torch.uint8)
    pred.predict(u8)
    torch.cuda.synchronize()
    _build.reset_launches()
    px, conf = pred.predict(u8)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    ms = median_ms(torch, lambda: pred.predict(u8), 5, 1)
    n, thr = YOLO_CPU_IMAGES, pred.threshold
    host = u8[:n].cpu()
    host_bf16, host_fp32 = served(device="cpu"), served(dtype=torch.float32, device="cpu")
    card_fp32 = served(dtype=torch.float32)
    (p_card, c_card), (p_cpu, c_cpu) = card_fp32.predict(u8[:n]), host_fp32.predict(host)
    v_card, v_cpu = c_card.cpu() >= thr, c_cpu >= thr
    both = v_card & v_cpu
    d = (p_card.cpu() - p_cpu).norm(dim=-1)
    fp32 = {"valid_card": int(v_card.sum()), "valid_cpu": int(v_cpu.sum()),
            "validity_disagreements": int((v_card != v_cpu).sum()),
            "conf_max_abs_diff": float((c_card.cpu() - c_cpu).abs().max()),
            "both_valid": int(both.sum()),
            "px_max_dist_where_both_valid": float(d[both].max()) if both.any() else None,
            "px_max_dist_all_corners": float(d.max())}
    ref = host_fp32.levels(host)
    dist = {"card": max(float((a.cpu() - b).abs().max())
                        for a, b in zip(pred.levels(u8[:n]), ref)),
            "cpu": max(float((a - b).abs().max()) for a, b in zip(host_bf16.levels(host), ref)),
            "level_max_abs": max(float(b.abs().max()) for b in ref)}
    fields = {"batch": YOLO_B, "hand_written_kernel_launches": launches,
              "predict_ms_b32": ms, "img_per_s": YOLO_B * 1e3 / ms, "cpu_images": n,
              "float32_card_vs_cpu": fp32, "bf16_levels_max_abs_vs_cpu_float32": dist,
              "mean_error_px_vs_render": float((px - corners).norm(dim=-1).mean())}
    bad = []
    if not (bool(torch.isfinite(px).all()) and bool(torch.isfinite(conf).all())):
        bad.append("outputs not finite")
    if fp32["validity_disagreements"] or not fp32["conf_max_abs_diff"] <= YOLO_TOL["served_conf"]:
        bad.append(f"float32 validity differs on {fp32['validity_disagreements']} corners, "
                   f"confidences by {fp32['conf_max_abs_diff']}")
    if fp32["both_valid"] and fp32["px_max_dist_where_both_valid"] > YOLO_TOL["served_px"]:
        bad.append(f"float32 corners {fp32['px_max_dist_where_both_valid']} px apart")
    if not dist["card"] <= YOLO_TOL["served_bf16_factor"] * dist["cpu"]:
        bad.append(f"bf16 levels from the CPU's float32: card {dist['card']}, CPU {dist['cpu']}")
    return fields, bad


def yolo_eval_card_vs_cpu(torch, ck: Path) -> tuple:
    """``CornerEvaluator`` (fp32 model, ``output_dir=None``: the card's
    machine has no matplotlib, which ``evaluate_pose_torch.py`` plots with)
    on the card and on the CPU over the same two held-out batches of 4 (the
    evaluate CLI's seeds 5,000,000 + i, rendered on the card): accuracies,
    mean and median error to 1e-3 relative; and the evaluation's ms per b32
    batch with the bf16 model."""
    from mtg_card_image_segmentation_tpu_torch.evaluation import CornerEvaluator
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import yolo_from_flax

    params, stats, _ = load_params(str(ck), "final_model")
    batches = [yolo_batch(torch, 4, 5_000_000 + i, "cuda") for i in range(2)]
    reps = {}
    for dev in ("cuda", "cpu"):
        model = yolo_from_flax(params, stats, dtype=torch.float32).to(dev)
        reps[dev] = CornerEvaluator(model, (YOLO_SIZE, YOLO_SIZE)).evaluate(
            [(x.to(dev), c.to(dev)) for x, c in batches], output_dir=None, worst_k=0)
    keys = [k for k in reps["cpu"] if k.startswith("accuracy_")] + [
        "mean_error_px", "median_error_px"]
    rel = {k: abs(reps["cuda"][k] - reps["cpu"][k]) / max(abs(reps["cpu"][k]), 1e-12)
           if reps["cuda"][k] != reps["cpu"][k] else 0.0 for k in keys}
    bf16 = yolo_from_flax(params, stats, dtype=torch.bfloat16).to("cuda")
    ev, big = CornerEvaluator(bf16, (YOLO_SIZE, YOLO_SIZE)), [yolo_batch(torch, YOLO_B, 2, "cuda")]
    ms = median_ms(torch, lambda: ev.evaluate(big, worst_k=0), 5, 2)
    fields = {"images": 8, "card": {k: reps["cuda"][k] for k in keys},
              "cpu": {k: reps["cpu"][k] for k in keys}, "rel_err": rel,
              "detection_rate": [reps[d]["detection_rate"] for d in ("cuda", "cpu")],
              "eval_ms_per_batch_bf16_b32": ms}
    bad = [f"evaluator {k}: card {reps['cuda'][k]} CPU {reps['cpu'][k]}"
           for k, v in rel.items() if v > YOLO_TOL["eval_rel"]]
    return fields, bad


def yolo_export(torch, root: Path, ck: Path) -> tuple:
    """``export_yolo_torch.py`` of the trained checkpoint: the CLI gates its
    package on the card. fp32 and both dynamic gates must pass, fp16 and
    int8 may miss (a barely trained tree's fp16 pixel rows and int8 corners
    are the CLI's report, as for pose), the exit code must agree; a missed
    fp32 or dynamic gate is excused only where the card's max|diff| is at
    most twice the same CLI's on the CPU from the same checkpoint
    (``export_gate_refereed``). Then the artifacts run by the executor on
    the card and on the CPU on the CLI's probe kind ([0,1] noise, b1; the
    dynamic graph also at b4): the float32 and int8 graphs within 1e-5 of
    the largest output value, the fp16 graph no further from the fp32
    model on the card than twice the CPU's."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
    from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import yolo_from_flax
    from export_yolo_torch import output0

    out_dir = root / "export_yolo"
    args = ["--checkpoint", str(ck / "final_model")]
    run = _cli([*args, "--output-dir", str(out_dir)], "export_yolo", root,
               "export_yolo_torch.py", exits=(0, 1))
    log = (root / "export_yolo.log").read_text()
    verdicts = export_gate_verdicts(log)
    readings, cpu_readings, refereed = export_gate_readings(log), None, frozenset()
    if {g for g, v in verdicts.items() if v == "FAIL"} & set(REFEREED_GATES):
        _cli([*args, "--device", "cpu", "--output-dir", f"{out_dir}_cpu"], "export_yolo_cpu",
             root, "export_yolo_torch.py", exits=(0, 1))
        cpu_readings = export_gate_readings((root / "export_yolo_cpu.log").read_text())
        refereed = export_gate_refereed(verdicts, readings, cpu_readings)
    faults = export_gate_faults(run, verdicts, frozenset({"fp16", "int8"}) | refereed)
    s = YOLO_SIZE
    x1 = np.random.default_rng(0).random((1, 3, s, s)).astype(np.float32)
    x4 = np.random.default_rng(1).random((4, 3, s, s)).astype(np.float32)
    params, stats, _ = load_params(str(ck), "final_model")
    model = yolo_from_flax(fold_batch_norm(params, stats), None, dtype=torch.float32)
    with torch.inference_mode():
        ref = output0(*(o.numpy() for o in model(
            torch.from_numpy(np.ascontiguousarray(x1.transpose(0, 2, 3, 1))))))
    rows = []
    for art, x in (("yolo.onnx", x1), ("yolo_dynamic.onnx", x1), ("yolo_dynamic.onnx", x4),
                   ("yolo_int8.onnx", x1), ("yolo_fp16.onnx", x1)):
        graph = op.Model.load(str(out_dir / art))
        runners = {dev: make_runner(graph, dev) for dev in ("cuda", "cpu")}
        card_out, host = (runners[dev]({"input": x})["output0"] for dev in ("cuda", "cpu"))
        row = {"artifact": art, "batch": x.shape[0],
               "finite": bool(np.isfinite(card_out).all()),
               "card_vs_cpu_max_abs": float(np.abs(card_out - host).max()),
               "output_max_abs": float(np.abs(host).max())}
        if art == "yolo_fp16.onnx":
            row["card_vs_fp32_model"] = float(np.abs(card_out - ref).max())
            row["cpu_vs_fp32_model"] = float(np.abs(host - ref).max())
            row["pass"] = row["finite"] and (row["card_vs_fp32_model"]
                                             <= YOLO_TOL["fp16_factor"] * row["cpu_vs_fp32_model"])
        else:
            row["card_ms"] = median_ms(torch, lambda: runners["cuda"]({"input": x}), 3, 1)
            row["pass"] = row["finite"] and (row["card_vs_cpu_max_abs"]
                                             <= YOLO_TOL["executor_rel"] * row["output_max_abs"])
        rows.append(row)
    program, bad_program = program_fields(out_dir / "yolo.pt2")
    devices, bad_devices = yolo_program_devices(torch, out_dir, ck, root)
    fields = {"cli_exit": run["exit"], "cli_wall_seconds": run["wall_seconds"],
              "cli_gates": [ln for ln in log.splitlines() if re.match(r"\S+ parity", ln)],
              "cli_verdicts": verdicts, "may_miss": ["fp16", "int8"],
              "card_readings": readings, "cpu_referee_readings": cpu_readings,
              "refereed": sorted(refereed), "cli_faults": faults,
              "torch_export": program, "torch_export_devices": devices,
              "yolo_info_parity": (json.loads((out_dir / "yolo_info.json").read_text())["parity"]
                                   if (out_dir / "yolo_info.json").exists() else None),
              "sizes_mb": {a: (out_dir / a).stat().st_size / 1e6 for a in YOLO_ARTIFACTS},
              "executor_card_vs_cpu": rows}
    bad = [f"export CLI: {f}" for f in faults] + [f"executor: {r}" for r in rows
                                                   if not r["pass"]]
    bad += bad_program + bad_devices
    if run["device"] is None or not run["device"].startswith("cuda"):
        bad.append(f"export ran off the card: {run['device']}")
    if not (out_dir / "decode_yolo.py").exists():
        bad.append("no decode_yolo.py in the package")
    return out_dir, fields, bad


def yolo_inference_cli(pkg: Path, ck: Path, root: Path) -> tuple:
    """``pose_inference_torch.py --family yolo`` through ``main(argv)`` in
    this process, on the card: on the package directory, where the ladder
    must choose the int8 rung and fall past nothing, on the checkpoint, and
    with ``--pt2`` against ``--onnx`` on the fp32 graph (both under
    ``ieee_fp32()``: one client decode of one output0, corners within
    0.02 px), two synthetic samples each."""
    import math

    import pose_inference_torch

    from mtg_card_image_segmentation_tpu_torch.utils.platform import ieee_fp32

    calls = {"yolo_onnx": (["--onnx", str(pkg)], "yolo_int8.onnx"),
             "yolo_checkpoint": (["--checkpoint", str(ck)], None),
             "yolo_pt2": (["--pt2", str(pkg)], "yolo.pt2"),
             "yolo_onnx_fp32": (["--onnx", str(pkg / "yolo.onnx")], "yolo.onnx")}
    fields, bad = {}, []
    for name, (args, rung) in calls.items():
        t0 = time.perf_counter()
        # the float32 artifacts with the host's fp32 accuracy, as the export
        # gates run them
        with ieee_fp32() if name in ("yolo_pt2", "yolo_onnx_fp32") else nullcontext():
            r = pose_inference_torch.main([*args, "--family", "yolo", "--synthetic", "2",
                                           "--output-dir", str(root / f"inference_{name}")])
        fields[name] = {"source": Path(r["source"]).name,
                        "ladder_fell_past": r["ladder_fell_past"],
                        "seconds": time.perf_counter() - t0, "results": r["results"]}
        if rung is not None and (fields[name]["source"] != rung or r["ladder_fell_past"]):
            bad.append(f"{name}: chose {fields[name]['source']}, fell past "
                       f"{r['ladder_fell_past']}")
        for res in r["results"]:
            if not all(math.isfinite(v) for row in res["corners_xy"] for v in row):
                bad.append(f"{name}: not finite {res}")
    # the program and the fp32 graph: one client decode of one output0
    px = max(abs(a - b) for ra, rb in zip(fields["yolo_pt2"]["results"],
                                          fields["yolo_onnx_fp32"]["results"])
             for pa, pb in zip(ra["corners_xy"], rb["corners_xy"]) for a, b in zip(pa, pb))
    fields["pt2_vs_onnx_fp32_px"] = px
    if not px <= PROGRAM_CLI_TOL["yolo_px"]:
        bad.append(f"yolo --pt2 vs the fp32 graph: {px} px")
    return fields, bad


def yolo_train_numbers(torch, card) -> dict:
    """The YOLO train step at the default config's 640x640 b32 (bf16,
    AdamW): ms, img/s and peak memory (median of 10 steps after 3), and a
    ``torch.profiler`` pass of 3 steps: kernel time by class, launches and
    the device's idle share."""
    from mtg_card_image_segmentation_tpu_torch.models.registry import create_model
    from mtg_card_image_segmentation_tpu_torch.training.optim import OptimizerDef
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.training.yolo_loss import make_yolo_train_step
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_defaults

    model = init_flax_defaults(create_model("yolo12n_pose"), SEED)
    state = create_seg_state(model, OptimizerDef("adamw", 1e-4, 0.9, None, lambda c: 1e-3),
                             torch.device("cuda"))
    imgs, corners = yolo_batch(torch, YOLO_B, SEED + 82, "cuda")
    step = make_yolo_train_step()
    for _ in range(3):
        step(state, imgs, corners)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(torch, lambda: step(state, imgs, corners), 10, 0)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_calls(torch, lambda: step(state, imgs, corners), 3)
    emit({"phase": "profile", "path": "yolo_train_step", "batch": YOLO_B,
          "size": [YOLO_SIZE, YOLO_SIZE], **prof, "card": card["name"],
          "nvidia_smi": card["nvidia_smi"]})
    return {"step_ms": ms, "img_per_s": YOLO_B * 1e3 / ms, "peak_mem_bytes": peak,
            "profile_kernel_ms_per_step": prof["kernel_ms_per_call"],
            "profile_launches_per_step": prof["kernel_launches_per_call"],
            "profile_device_idle_share": prof["device_idle_share"]}


def phase_yolo_pipeline(torch, card, root: Path) -> None:
    """YOLO12n-pose training, evaluation, export and ONNX inference on the
    card at full width and the default config's 640x640, b32, bf16: one
    train step card vs CPU (``yolo_train_fp32_card_vs_cpu``),
    ``train_yolo_torch.py`` for 2 epochs x 8 steps and a resumed third, the
    trained checkpoint served through ``YoloCornerPredictor``,
    ``CornerEvaluator`` card vs CPU, ``export_yolo_torch.py`` with the
    artifacts card vs CPU, ``pose_inference_torch.py --family yolo`` on the
    package and the checkpoint, and the train step's numbers and profile.
    The YOLO path launches none of the hand-written kernels: the served
    call's launches are recorded, not gated."""
    t_start = time.perf_counter()
    yolo_train_gate_fp32(torch, card)
    ck, train = yolo_train_cli(torch, card, root)
    served, bad = yolo_served(torch, ck)
    evaluated, bad_eval = yolo_eval_card_vs_cpu(torch, ck)
    pkg, exported, bad_export = yolo_export(torch, root, ck)
    clis, bad_cli = yolo_inference_cli(pkg, ck / "final_model", root)
    numbers = yolo_train_numbers(torch, card)
    bad += bad_eval + bad_export + bad_cli
    emit({"phase": "yolo_pipeline", "size": [YOLO_SIZE, YOLO_SIZE], "batch": YOLO_B,
          "train_cli": train, "served": served, "evaluator_card_vs_cpu": evaluated,
          "export": exported, "inference_cli": clis, "train_step": numbers,
          "tolerance": YOLO_TOL, "seconds": time.perf_counter() - t_start,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if bad:
        fail(f"yolo_pipeline: {bad}")


DIST_HW, DIST_B = (320, 240), 32   # the seg config's train step
DIST_SGD = dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.05)
DIST_FP32_FACTOR = 2.0             # fp32 distance from float64 / the plain step's
DIST_LOSS_REL = 1e-6


def dist_record(state, stats) -> dict:
    """A train step's loss, gradients and BN statistics as float64 numpy."""
    out = {"loss": float(stats["loss"])}
    out.update({f"grad/{n}": p.grad.double().cpu().numpy()
                for n, p in state.model.named_parameters()})
    out.update({f"buffer/{n}": b.double().cpu().numpy()
                for n, b in state.model.named_buffers() if "running" in n})
    return out


def dist_distance(rec: dict, ref: dict, prefix: str) -> float:
    """The worst tensor's max|rec - ref| over its largest |ref| (floored at
    1e-5 of the largest entry of all: gradients zero in exact arithmetic);
    ``tests/test_torch_distributed.py``'s measure."""
    import numpy as np

    keys = [k for k in ref if k.startswith(prefix)]
    top = max(float(np.abs(ref[k]).max()) for k in keys)
    return max(float(np.abs(rec[k] - ref[k]).max()) / max(float(np.abs(ref[k]).max()),
                                                          1e-5 * top) for k in keys)


def dist_step(torch, imgs, masks, mesh=None, timed: int = 0):
    """One fp32 SGD step of the seg model (Flax default init from SEED) on
    (imgs, masks): its record, and with ``timed`` the median ms of that many
    further steps."""
    from mtg_card_image_segmentation_tpu_torch.training.loop import make_train_step

    state = train_state(torch, DIST_SGD, "float32")
    step = make_train_step(mesh=mesh)
    _, stats = step(state, imgs, masks)
    rec = dist_record(state, stats)
    if timed:
        rec["step_ms"] = median_ms(torch, lambda: step(state, imgs, masks), timed, 1)
    return rec


def distributed_worker(rank: str, port: str, work: str) -> int:
    """One rank of the ``distributed`` phase's two-process gloo group on the
    one card (``python3 chip_smoke.py distributed-worker <rank> <port>
    <dir>``): its half of the b32 batch, one step recorded, the median step
    ms, and the median ms of an all-reduce of all the gradients (one flat
    fp32 buffer on the card, through the host)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from mtg_card_image_segmentation_tpu_torch.parallel import distributed, make_mesh

    rank = int(rank)
    distributed.initialize(f"localhost:{port}", 2, rank, device="cpu")  # gloo
    torch.cuda.set_device(0)
    with np.load(Path(work) / "dist_inputs.npz") as z:
        lo, hi = rank * DIST_B // 2, (rank + 1) * DIST_B // 2
        imgs, masks = (torch.from_numpy(z[k][lo:hi]).cuda() for k in ("images", "masks"))
    rec = dist_step(torch, imgs, masks, make_mesh(devices=["cuda:0"]), timed=5)
    flat = torch.randn(sum(v.size for k, v in rec.items() if k.startswith("grad/")),
                       device="cuda")
    rec["allreduce_ms"] = median_ms(torch, lambda: torch.distributed.all_reduce(flat), 5, 1)
    rec["allreduce_mb"] = flat.numel() * 4 / 1e6
    np.savez(Path(work) / f"dist_rank{rank}.npz", **rec)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_distributed(torch, card, root: Path) -> tuple:
    """Data-parallel training and batch-split serving on the one card, the
    seg config's fp32 train step at 320x240 b32 (cuDNN deterministic for
    the comparison, restored after): (a) this process in an ``nccl`` group
    of one rank, DDP and the global BatchNorm, against the plain step; (b)
    two processes on the card in a ``gloo`` group (NCCL refuses two ranks on
    one GPU), local b16 each, against the plain b32 step; each holds the
    loss to 1e-6 relative and its gradients and BN statistics no further
    from the float64 plain step than twice the plain fp32 step's
    (``tests/test_torch_distributed.py``'s rule); (c) ``SegPredictor(mesh=
    make_mesh())`` at b32 through kernels 1-3, its masks equal to the plain
    predictor's. Returns (c)'s kernel launches, and the plain fp32 and
    float64 step records (the ``space`` phase's references; the batch is
    ``<root>/dist_inputs.npz``)."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
    from mtg_card_image_segmentation_tpu_torch.parallel import distributed, make_mesh
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
    from mtg_card_image_segmentation_tpu_torch.training.loop import (
        float64_casts,
        float64_copy,
        make_train_step,
    )
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_like

    t_start = time.perf_counter()
    (h, w), b = DIST_HW, DIST_B
    imgs, masks = card_batch(torch, b, h, w, SEED + 500)
    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = dist_step(torch, imgs, masks, timed=5)
        with float64_casts():
            state = train_state(torch, DIST_SGD, "float32")
            state.model = float64_copy(state.model).train()
            state.optimizer = state.opt_def.build(state.model.parameters())
            _, stats = make_train_step()(state, imgs.double(), masks)
            exact = dist_record(state, stats)
        del state
        # (b) two gloo ranks on the card, in subprocesses
        np.savez(root / "dist_inputs.npz", images=imgs.cpu().numpy(), masks=masks.cpu().numpy())
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "distributed-worker", str(r), str(port), str(root)],
                                  cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(p.returncode for p in procs):
            fail(f"distributed workers: {[p.returncode for p in procs]}: "
                 f"{[o[-2000:] for o in outs]}")
        ranks = [dict(np.load(root / f"dist_rank{r}.npz")) for r in range(2)]
        # (a) this process, an nccl group of one rank
        distributed.initialize(f"localhost:{_free_port()}", 1, 0, device="cuda")
        try:
            one = dist_step(torch, imgs, masks, make_mesh(), timed=5)
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = kept
    rows, bad = {}, []
    d_plain = {p: dist_distance(plain, exact, p) for p in ("grad/", "buffer/")}
    for name, rec in (("nccl_1_rank", one), ("gloo_2_ranks", ranks[0])):
        row = {"loss_rel": abs(float(rec["loss"]) - plain["loss"]) / abs(plain["loss"]),
               "step_ms": float(rec["step_ms"]),
               **{f"{p[:-1]}_distance_from_float64": dist_distance(rec, exact, p)
                  for p in ("grad/", "buffer/")}}
        rows[name] = row
        if not row["loss_rel"] <= DIST_LOSS_REL:
            bad.append(f"{name} loss {rec['loss']} vs plain {plain['loss']}")
        for p in ("grad/", "buffer/"):
            if not row[f"{p[:-1]}_distance_from_float64"] <= DIST_FP32_FACTOR * d_plain[p]:
                bad.append(f"{name} {p[:-1]}: {row} against plain {d_plain}")
    rows["gloo_2_ranks"].update({"allreduce_ms": float(ranks[0]["allreduce_ms"]),
                                 "allreduce_mb": float(ranks[0]["allreduce_mb"])})
    if any(not np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0]
           if k.startswith(("grad/", "buffer/"))):
        bad.append("the two gloo ranks hold different gradients or statistics")
    # (c) batch-split serving on the one card's mesh
    weights = init_flax_like(SEED)
    u8, _ = card_images_u8(torch, b, h, w, SEED + 501)
    mesh = make_mesh()
    split, base = SegPredictor(*weights, h, w, mesh=mesh), SegPredictor(*weights, h, w)
    want = base.predict(u8)
    split.predict(u8)
    torch.cuda.synchronize()
    _build.reset_launches()
    got = split.predict(u8)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    equal = bool(torch.equal(got, want))
    if not equal:
        bad.append("batch-split masks differ from the plain predictor's")
    emit({"phase": "distributed", "size": [h, w], "batch": b,
          "plain_step_ms": plain["step_ms"], "plain_distance_from_float64": d_plain,
          "steps": rows, "loss_plain": plain["loss"], "loss_float64": exact["loss"],
          "served": {"mesh_devices": [str(d) for d in mesh.devices], "masks_equal": equal,
                     "launches": launches},
          "tolerance": {"loss_rel": DIST_LOSS_REL, "fp32_factor": DIST_FP32_FACTOR},
          "seconds": time.perf_counter() - t_start,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if bad:
        fail(f"distributed: {bad}")
    _check_seg_launches("distributed_served", launches)
    return launches, {"plain": plain, "exact": exact}


SPACE_POSE_B = 4                   # the HRNet step of the space phase: 480x640 b4
SPACE_FLOAT64_TOL = 1e-12          # float64 sharded step vs plain, of each tensor's max
SPACE_ZERO = 1e-9                  # a gradient below this share of the largest is zero


def space_pose_step(torch, imgs, targets, mesh=None, timed: int = 0, float64: bool = False):
    """One SGD step of the full HRNet (seeded Flax-like weights, 120x160
    heatmaps) on (imgs, targets), fp32 or float64: its record, and with
    ``timed`` the median ms of that many further steps."""
    from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig
    from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetPose
    from mtg_card_image_segmentation_tpu_torch.training.loop import (
        float64_casts,
        float64_copy,
        make_pose_train_step,
    )
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        flax_to_state_dict,
        init_hrnet_flax_like,
    )

    model = HRNetPose(heatmap_height=POSE_HEATMAP_HW[0], heatmap_width=POSE_HEATMAP_HW[1],
                      dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(*init_hrnet_flax_like(SEED)), strict=True)
    model = model.to(imgs.device).train()
    opt_def, _ = create_optimizer(OptimizerConfig(**DIST_SGD), 1, 10)
    step = make_pose_train_step(mesh=mesh)
    with float64_casts() if float64 else nullcontext():
        if float64:
            model = float64_copy(model).train()
            imgs, targets = imgs.double(), targets.double()
        state = create_seg_state(model, opt_def)
        _, stats = step(state, imgs, targets)
        rec = dist_record(state, stats)
        if timed:
            rec["step_ms"] = median_ms(torch, lambda: step(state, imgs, targets), timed, 1)
    return rec


def space_halo_ms(torch, fn) -> float:
    """The row exchanges' time in one call of ``fn``
    (``parallel/space.py::EXCHANGE_TIMER``: each exchange between two
    device synchronizes)."""
    from mtg_card_image_segmentation_tpu_torch.parallel import space

    space.EXCHANGE_TIMER = {}
    try:
        fn()
        return space.EXCHANGE_TIMER.get("seconds", 0.0) * 1e3
    finally:
        space.EXCHANGE_TIMER = None


def space_worker(rank: str, port: str, work: str) -> int:
    """One rank of the ``space`` phase's two-process gloo group on the one
    card (``python3 chip_smoke.py space-worker <rank> <port> <dir>``), mesh
    (data=1, space=2): its rows of the seg b32 batch and of the HRNet b4
    batch; each fp32 step recorded and timed, the row exchanges' ms in one
    step, and the float64 seg step."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from mtg_card_image_segmentation_tpu_torch.parallel import distributed, make_mesh, shard_batch
    from mtg_card_image_segmentation_tpu_torch.training.loop import (
        float64_casts,
        float64_copy,
        make_train_step,
    )

    rank = int(rank)
    distributed.initialize(f"localhost:{port}", 2, rank, device="cpu")  # gloo
    torch.cuda.set_device(0)
    mesh = make_mesh(space=2, devices=["cuda:0"])
    out = {}
    with np.load(Path(work) / "dist_inputs.npz") as z:
        (imgs, masks), = shard_batch(mesh, *(torch.from_numpy(z[k]).cuda()
                                             for k in ("images", "masks")))
    rec = dist_step(torch, imgs, masks, mesh, timed=5)
    state = train_state(torch, DIST_SGD, "float32")
    step = make_train_step(mesh=mesh)
    step(state, imgs, masks)
    rec["halo_ms"] = space_halo_ms(torch, lambda: step(state, imgs, masks))
    rec["rows"] = imgs.shape[1]
    out["seg"] = rec
    del state
    with float64_casts():
        state = train_state(torch, DIST_SGD, "float32")
        state.model = float64_copy(state.model).train()
        state.optimizer = state.opt_def.build(state.model.parameters())
        _, stats = step(state, imgs.double(), masks)
        out["seg_float64"] = dist_record(state, stats)
    del state
    with np.load(Path(work) / "space_pose_inputs.npz") as z:
        (pimgs, ptargets), = shard_batch(mesh, *(torch.from_numpy(z[k]).cuda()
                                                 for k in ("images", "targets")))
    rec = space_pose_step(torch, pimgs, ptargets, mesh, timed=3)
    rec["halo_ms"] = space_halo_ms(
        torch, lambda: space_pose_step(torch, pimgs, ptargets, mesh))
    rec["rows"] = pimgs.shape[1]
    out["hrnet"] = rec
    for name, r in out.items():
        np.savez(Path(work) / f"space_{name}_rank{rank}.npz", **r)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def space_float64_misses(rec: dict, ref: dict) -> list:
    """Tensors of a float64 sharded step farther than 1e-12 of their
    largest entry (the model's largest where the tensor is zero in exact
    arithmetic) from the plain float64 step's."""
    import numpy as np

    bad = []
    for prefix in ("grad/", "buffer/"):
        keys = [k for k in ref if k.startswith(prefix)]
        top = max(float(np.abs(ref[k]).max()) for k in keys)
        for k in keys:
            vmax = float(np.abs(ref[k]).max())
            scale = top if vmax <= SPACE_ZERO * top else vmax
            err = float(np.abs(rec[k] - ref[k]).max())
            if not err <= SPACE_FLOAT64_TOL * scale:
                bad.append((k, err / scale))
    return bad


def phase_space(torch, card, root: Path, refs: dict) -> None:
    """The mesh's spatial axis on the one card: two gloo ranks
    (``space-worker``), mesh (data=1, space=2), each holding half the rows
    of every map and exchanging halo rows through the host. The seg config's
    fp32 step at 320x240 b32 (160 rows per rank; the ``distributed`` phase's
    batch and its plain fp32 and float64 steps) and the full HRNet's fp32
    step at 480x640 b4 (its s32 branch of 15 rows split 8/7), each held by
    the ``distributed`` rule: the loss within 1e-6 of the plain step's, the
    gradients and BN statistics no farther from the float64 plain step than
    twice the plain fp32 step's distance; the float64 sharded seg step
    equal to the float64 plain step to 1e-12 of each tensor's largest
    entry. cuDNN deterministic, TF32 off. Prints each step's ms and the
    row exchanges' share of it."""
    import numpy as np

    t_start = time.perf_counter()
    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        imgs, targets, _ = pose_batch(torch, SPACE_POSE_B, SEED + 600, device="cuda")
        pose_plain = space_pose_step(torch, imgs, targets, timed=3)
        pose_exact = space_pose_step(torch, imgs, targets, float64=True)
        np.savez(root / "space_pose_inputs.npz", images=imgs.cpu().numpy(),
                 targets=targets.cpu().numpy())
        del imgs, targets
        torch.cuda.empty_cache()
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "space-worker",
                                   str(r), str(port), str(root)], cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=400)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            fail(f"space workers: {[p.returncode for p in procs]}: "
                 f"{[o[-2000:] for o in outs]}")
    finally:
        torch.backends.cudnn.deterministic = kept
    ranks = [{n: dict(np.load(root / f"space_{n}_rank{r}.npz"))
              for n in ("seg", "hrnet", "seg_float64")} for r in range(2)]
    bad, rows = [], {}
    for name, plain, exact in (("seg", refs["plain"], refs["exact"]),
                               ("hrnet", pose_plain, pose_exact)):
        rec = ranks[0][name]
        d_plain = {p: dist_distance(plain, exact, p) for p in ("grad/", "buffer/")}
        row = {"rows_per_rank": [int(r[name]["rows"]) for r in ranks],
               "loss_plain": plain["loss"], "loss_float64": exact["loss"],
               "loss_rel": abs(float(rec["loss"]) - plain["loss"]) / abs(plain["loss"]),
               "plain_step_ms": plain["step_ms"],
               "space_step_ms": [float(r[name]["step_ms"]) for r in ranks],
               "halo_ms": [float(r[name]["halo_ms"]) for r in ranks],
               "plain_distance_from_float64": d_plain,
               **{f"{p[:-1]}_distance_from_float64": dist_distance(rec, exact, p)
                  for p in ("grad/", "buffer/")}}
        row["halo_share_of_step"] = [h / t for h, t in zip(row["halo_ms"],
                                                           row["space_step_ms"])]
        rows[name] = row
        if not row["loss_rel"] <= DIST_LOSS_REL:
            bad.append(f"{name} loss {rec['loss']} vs plain {plain['loss']}")
        for p in ("grad/", "buffer/"):
            if not row[f"{p[:-1]}_distance_from_float64"] <= DIST_FP32_FACTOR * d_plain[p]:
                bad.append(f"{name} {p[:-1]}: {row}")
        if any(not np.array_equal(ranks[0][name][k], ranks[1][name][k]) for k in rec
               if k.startswith(("grad/", "buffer/"))):
            bad.append(f"{name}: the two ranks hold different gradients or statistics")
    misses = space_float64_misses(ranks[0]["seg_float64"], refs["exact"])
    rows["seg_float64"] = {
        "loss_rel": abs(float(ranks[0]["seg_float64"]["loss"]) - refs["exact"]["loss"])
        / abs(refs["exact"]["loss"]), "tensors_off": misses[:5]}
    if misses or not rows["seg_float64"]["loss_rel"] <= SPACE_FLOAT64_TOL:
        bad.append(f"float64 sharded seg step: {rows['seg_float64']}")
    emit({"phase": "space", "mesh": {"data": 1, "space": 2}, "backend": "gloo (host-staged)",
          "seg": {"size": list(DIST_HW), "batch": DIST_B, **rows["seg"]},
          "hrnet": {"size": list(POSE_HW), "batch": SPACE_POSE_B, **rows["hrnet"]},
          "seg_float64": rows["seg_float64"],
          "tolerance": {"loss_rel": DIST_LOSS_REL, "fp32_factor": DIST_FP32_FACTOR,
                        "float64": SPACE_FLOAT64_TOL},
          "seconds": time.perf_counter() - t_start,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if bad:
        fail(f"space: {bad}")


TOOLS_GEN = ("--train", "64", "--test", "16", "--height", "320", "--width", "240")
TTA_TOL = 1e-6          # tta_batch card vs CPU, max|d| of [0,1] images
ENTRY_AGREEMENT = 0.998  # bf16 argmax agreement, card vs CPU


def _run_cli(args, timeout: int = 300) -> dict:
    """Run a CLI of the repo; its last JSON line."""
    p = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    if p.returncode:
        fail(f"{args[0]}: rc {p.returncode}: {p.stdout[-2000:]} {p.stderr[-2000:]}")
    return json.loads([ln for ln in p.stdout.splitlines() if ln.startswith("{")][-1])


def tools_conv_layout(torch) -> tuple:
    """``tools/half_conv_layout_torch.py`` over the port's half-precision
    convs: (fields, faults). A combination the port executes that is wrong
    is a fault; the others are recorded (the first 8, and their count)."""
    import half_conv_layout_torch

    rec = half_conv_layout_torch.run("cuda")

    def brief(row):
        return {"call": {k: row["call"][k] for k in ("x", "w", "stride", "dilation", "groups",
                                                     "transposed", "dtype")},
                "layout": row["layout"], "rel_err": row["rel_err"], "nan": row["nan"],
                "backends": row["backends"], "paths": row["paths"]}

    fields = {k: rec[k] for k in ("paths", "distinct_calls", "by_dtype_layout",
                                  "capture_seconds", "seconds")}
    fields["wrong_executed"] = [brief(r) for r in rec["wrong_executed"]]
    fields["wrong_not_executed"] = [brief(r) for r in rec["wrong_not_executed"][:8]]
    fields["wrong_not_executed_count"] = len(rec["wrong_not_executed"])
    bad = [f"half-precision convs wrong in the layout the port runs: "
           f"{fields['wrong_executed'][:3]}"] if rec["wrong_executed"] else []
    return fields, bad


SLIM_FIXTURE_ROUNDS = 3     # timed rounds of 5 predicts each
SLIM_FIXTURE_CPU_IMAGES = 4


def tools_slim_fixture(torch, root: Path) -> tuple:
    """``tools/make_slim_fixture_torch.py`` run as a CLI into ``root``, its
    checkpoint loaded through ``slim_seg_state`` and served at 512x512 b128
    (as ``bench.py --slim`` serves the JAX fixture): ms per batch over
    rounds, peak memory, one predict's exact launches of kernels 2 and 1;
    kernels 2, 1 and 4 against their plain versions on the inputs that
    predict gave them (the tail chain at the fixture's narrowed widths);
    masks against the CPU path on 4 images (>= 0.999); and the fixture
    through ``tools/profile_blocks_torch.py --slim`` (kernels 4 and 1, 3
    passes). Returns (fields, {path: launches}, faults)."""
    import numpy as np
    import profile_blocks_torch

    from mtg_card_image_segmentation_tpu_torch.compression.slim import (
        param_count,
        slim_seg_state,
    )
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import decoder as dec
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import fused_block as fb
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import preprocess as pre
    from mtg_card_image_segmentation_tpu_torch.serving import predictor as seg
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params

    bad = []
    out_dir = root / "slim_fixture"
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "tools/make_slim_fixture_torch.py", "--output-dir",
                        str(out_dir)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if p.returncode:
        fail(f"make_slim_fixture_torch.py: rc {p.returncode}: {p.stdout[-2000:]} "
             f"{p.stderr[-2000:]}")
    params, stats, meta = load_params(str(out_dir), "slim_model")
    sp, ss, overrides = slim_seg_state(params, stats)
    pred = seg.SegPredictor(sp, ss, SIZE, SIZE)
    u8 = np.random.default_rng(SEED + 900).integers(0, 256, (BATCHES[-1], SIZE, SIZE, 3),
                                                    dtype=np.uint8)
    imgs = torch.from_numpy(u8).cuda()
    rounds = [_time_predict(torch, pred, imgs) for _ in range(SLIM_FIXTURE_ROUNDS)]
    counts = rounds[-1][2]
    _check_seg_launches("slim fixture", counts)

    # the kernels on the inputs the fixture's predict hands them
    seen = {}
    chain, decode = seg.fused_tail_chain, seg.fused_mask_decode

    def keep_chain(x, tail, **kw):
        seen["chain"] = (x, tail, kw)
        return chain(x, tail, **kw)

    def keep_decode(score, h, w):
        seen["decode"] = score
        return decode(score, h, w)

    seg.fused_tail_chain, seg.fused_mask_decode = keep_chain, keep_decode
    try:
        masks = pred.predict(imgs)
    finally:
        seg.fused_tail_chain, seg.fused_mask_decode = chain, decode
    x, tail, kw = seen["chain"]
    chain_err = float((fb.fused_tail_chain(x, tail, **kw).float()
                       - fb.tail_chain_plain(x, tail, kw["act"], kw["dilation"]).float())
                      .abs().max())
    score = seen["decode"]
    decode_mismatch = int((dec.fused_mask_decode(score, SIZE, SIZE)
                           != dec.fused_mask_decode_plain(score, SIZE, SIZE)).sum())
    norm_equal = bool(torch.equal(pre.fused_normalize(imgs, torch.bfloat16),
                                  pre.fused_normalize_plain(imgs, torch.bfloat16)))
    kernels = {"fused_tail_chain": {"shape": list(x.shape), "widths": [bw.cexp for bw in tail],
                                    "max_abs_err": chain_err, "within_tol": chain_err <= TOL},
               "fused_mask_decode": {"shape": list(score.shape), "mismatches": decode_mismatch},
               "fused_normalize": {"shape": list(imgs.shape), "bit_equal": norm_equal}}
    if not chain_err <= TOL or decode_mismatch or not norm_equal:
        bad.append(f"slim fixture kernels against their plain versions: {kernels}")

    n = SLIM_FIXTURE_CPU_IMAGES
    cpu = seg.SegPredictor(sp, ss, SIZE, SIZE, device="cpu")
    agree = float((masks[:n].cpu() == cpu.predict(u8[:n])).float().mean())
    del cpu, pred
    if masks.dtype != torch.uint8 or tuple(masks.shape) != (BATCHES[-1], SIZE, SIZE) \
            or not agree >= 0.999:
        bad.append(f"slim fixture masks {masks.dtype} {tuple(masks.shape)}, agreement with "
                   f"the CPU path {agree} (gate 0.999)")
    torch.cuda.empty_cache()

    prof = profile_blocks_torch.run(size=SIZE, batch=BATCHES[-1], iters=3, warmup=1,
                                    checkpoint=str(out_dir / "slim_model"), slim=True)
    if prof["launches"] != {"fused_normalize": 3, "fused_mask_decode": 3}:
        bad.append(f"slim fixture profile launches {prof['launches']}, want 3 of "
                   f"fused_normalize and fused_mask_decode")
    torch.cuda.empty_cache()
    fields = {"cli_seconds": cli_s, "cli_stdout": p.stdout.strip().splitlines(),
              "config": meta.get("config"), "narrowed_blocks": sum(o is not None
                                                                   for o in overrides),
              "tail_widths": list(overrides[12:]), "params": param_count(sp),
              "dense_params": param_count(params), "batch": BATCHES[-1], "size": SIZE,
              "calls_per_round": 5, "ms_per_batch_rounds": [r[0] for r in rounds],
              "ms_per_batch": min(r[0] for r in rounds),
              "peak_mem_bytes": max(r[1] for r in rounds), "launches_per_predict": counts,
              "kernels": kernels, "agreement_vs_cpu": agree, "cpu_images": n,
              "profile": {k: prof[k] for k in ("stages", "total_ms", "img_per_s", "launches")}}
    launches = {"served": counts, "profile": prof["launches"]}
    return fields, launches, bad


DECODE_KEYS = {"hrnet": {"heatmaps", "gt_corners", "indices", "dead_channel_conf",
                         "image_hw", "platform", "epoch"},
               "yolo": {"boxes", "scores", "kpts", "gt_corners", "indices",
                        "ungated_err_px", "image_hw", "platform", "epoch"}}


def tools_decode_fixtures(torch, root: Path) -> tuple:
    """``tools/make_decode_fixtures_torch.py --family hrnet`` and ``--family
    yolo`` (in-process, through ``main``) on the checkpoints that
    ``pose_pipeline`` and ``yolo_pipeline`` wrote, over the full eval stream
    (16 x 24 images): the npz keys, shapes and platform, and the indices
    against those the selection functions choose on the CPU from the same
    card outputs. Returns (fields, the HRNet channel maxima (N, K) on the
    host, faults)."""
    import numpy as np
    import make_decode_fixtures_torch as mdf

    fields, bad, chan_max = {}, [], None
    name = torch.cuda.get_device_name(0)
    for family, ck in (("hrnet", root / "ckpt_pose"), ("yolo", root / "ckpt_yolo")):
        t0 = time.perf_counter()
        rec = mdf.main(["--family", family, "--checkpoint", str(ck / "final_model"),
                        "--out", str(root / "decode_fixtures")])
        seconds = time.perf_counter() - t0
        z, o = np.load(rec["path"]), rec["outputs"]
        if family == "hrnet":
            chan_max = o["hm"].amax(dim=(1, 2)).cpu().numpy()
            cpu = mdf.hrnet_fixture(o["hm"].cpu(), o["gt"].cpu(), *POSE_HW)
            shapes = {"heatmaps": (4, *POSE_HEATMAP_HW, 4), "gt_corners": (4, 4, 2)}
        else:
            cpu = mdf.yolo_fixture(o["boxes"].cpu(), o["scores"].cpu(), o["kpts"].cpu(),
                                   o["gt"].cpu())
            a = o["boxes"].shape[1]
            shapes = {"boxes": (4, a, 4), "scores": (4, a, 1), "kpts": (4, a, 4, 3),
                      "gt_corners": (4, 4, 2)}
        cpu_idx = [int(i) for i in cpu["arrays"]["indices"]]
        n_images = next(iter(o.values())).shape[0]
        fields[family] = {"seconds": seconds, "images": n_images, "indices": rec["indices"],
                          "cpu_indices": cpu_idx, "platform": str(z["platform"]),
                          "epoch": int(z["epoch"]),
                          "shapes": {k: list(z[k].shape) for k in z.files},
                          "finite": all(bool(np.isfinite(z[k]).all()) for k in z.files
                                        if z[k].dtype.kind == "f")}
        if set(z.files) != DECODE_KEYS[family] or any(
                z[k].shape != s for k, s in shapes.items()) or n_images != 16 * 24 \
                or str(z["platform"]) != name or not fields[family]["finite"]:
            bad.append(f"decode fixture {family}: {fields[family]}")
        if cpu_idx != rec["indices"]:
            bad.append(f"decode fixture {family}: card indices {rec['indices']}, the CPU "
                       f"selection on the same outputs {cpu_idx}")
        del rec, o
        torch.cuda.empty_cache()
    return fields, chan_max, bad


def tools_dead_channel(torch, root: Path, chan_max_decode) -> tuple:
    """``tools/analyze_dead_channel_torch.py``'s analysis (``analyze``: the
    CLI without its panels, which need matplotlib) on the ``pose_pipeline``
    checkpoint over the full eval stream at ``--dead-conf 0.2``: the
    ``analysis.json`` keys, the report equal to the host's
    ``dead_channel_report`` of the returned maxima, and the channel maxima
    beside the decode-fixture run's. Returns (fields, faults)."""
    import numpy as np
    import analyze_dead_channel_torch as adc

    out = root / "dead_channel"
    t0 = time.perf_counter()
    report, chan_max, gt, dead_imgs = adc.analyze(str(root / "ckpt_pose" / "final_model"),
                                                  str(out))
    seconds = time.perf_counter() - t0
    written = json.loads((out / "analysis.json").read_text())
    host = adc.dead_channel_report(chan_max, gt, *POSE_HW, 0.2)
    dead = [e["index"] for e in report["dead_channel_images"]]
    fields = {"seconds": seconds, "num_images": report["num_images"], "dead_images": len(dead),
              "dead_indices_first": dead[:16],
              "weakest_channel_percentiles": report["weakest_channel_percentiles"],
              "chan_max_vs_decode_run_max_abs": float(np.abs(chan_max - chan_max_decode).max()),
              "dead_indices_equal_decode_run": dead == [
                  int(i) for i in np.where(chan_max_decode.min(axis=1) < 0.2)[0]]}
    bad = []
    if written != report or host != report or report["num_images"] != 16 * 24 \
            or set(dead_imgs) != set(dead) or set(report) != {
                "num_images", "dead_conf_threshold", "dead_channel_images", "population",
                "weakest_channel_percentiles"}:
        bad.append(f"dead-channel analysis: {fields}")
    return fields, bad


def phase_tools(torch, card, root: Path, seg_ck: Path) -> dict:
    """The graft entry, the block profiler and the data-generation
    surfaces on the card: ``graft_entry_torch.entry()`` (its logits against
    the same entry on the CPU); ``tools/profile_blocks_torch.py`` at 512x512
    b128 (5 passes; its ``norm`` cut launches ``fused_normalize``, its
    ``decode`` cut ``fused_mask_decode``); ``generate_dataset_torch.py``
    at 320x240 (64 train, 16 test, ``--derive-corners``, ``--yolo-output``)
    and the same command again, which must write nothing; ``tta_batch`` card
    vs CPU; the plot CLIs' computation (augmented samples, dataset
    statistics, the prediction grid of the ``train_cli`` checkpoint, card
    vs CPU); the half-precision conv layout map (``tools_conv_layout``); the
    slim fixture made and served (``tools_slim_fixture``); the decode
    fixtures and the dead-channel analysis on the ``pose_pipeline`` and
    ``yolo_pipeline`` checkpoints (``tools_decode_fixtures``,
    ``tools_dead_channel``). Returns the kernel launches of the profiler's
    run, the slim fixture's predict and its profile, by path."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tools"))
    import generate_examples_torch
    import graft_entry_torch
    import profile_blocks_torch
    import profile_pose_step_torch
    import visualize_augmentations_torch

    from mtg_card_image_segmentation_tpu_torch.data.aug_policies import tta_batch
    from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

    t_start = time.perf_counter()
    bad, out = [], {}
    # the graft entry
    fn, args = graft_entry_torch.entry()
    t0 = time.perf_counter()
    logits = fn(*args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    x = torch.randn((1, 320, 240, 3), generator=torch.Generator().manual_seed(SEED + 700))
    card_logits = fn(args[0], x.cuda()).float().cpu()
    cfn, cargs = graft_entry_torch.entry(device="cpu")
    cpu_logits = cfn(cargs[0], x).float()
    agree = float((card_logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean())
    out["entry"] = {"shape": list(logits.shape), "first_call_ms": first_ms,
                    "finite": bool(torch.isfinite(logits).all()),
                    "argmax_agreement_card_vs_cpu": agree,
                    "ms": median_ms(torch, lambda: fn(*args), 5, 1)}
    if tuple(logits.shape) != (1, 320, 240, 2) or not out["entry"]["finite"] \
            or not agree >= ENTRY_AGREEMENT:
        bad.append(f"entry: {out['entry']}")
    del fn, args, cfn, cargs
    # the block profiler: kernels 4 and 1 on its cuts
    _build.reset_launches()
    prof = profile_blocks_torch.run(size=SIZE, batch=128, iters=5, warmup=2)
    launches = dict(_build.LAUNCHES)
    out["profile_blocks"] = {k: prof[k] for k in ("method", "stages", "total_ms", "img_per_s",
                                                  "out_shape")}
    out["profile_blocks"]["launches"] = launches
    for k in ("fused_normalize", "fused_mask_decode"):
        if launches.get(k, 0) <= 0:
            bad.append(f"profile_blocks launched no {k}: {launches}")
    torch.cuda.empty_cache()
    # the pose-step profiler at the pose config's b24, a few steps
    pose = profile_pose_step_torch.run(batches=(POSE_B,), steps=3)
    out["profile_pose_step"] = {k: pose[k] for k in ("size", "heatmap", "steps", "rows")}
    if [r["batch"] for r in pose["rows"]] != [POSE_B] or not all(
            r["loss_finite"] and r["datagen_ms"] > 0 and r["train_step_ms"] > 0
            for r in pose["rows"]):
        bad.append(f"profile_pose_step: {pose['rows']}")
    torch.cuda.empty_cache()
    # dataset generation, then the resume
    ds, yolo = root / "gen_dataset", root / "gen_yolo"
    cmd = ["generate_dataset_torch.py", "--output", str(ds), *TOOLS_GEN, "--derive-corners",
           "--yolo-output", str(yolo)]
    t0 = time.perf_counter()
    first = _run_cli(cmd)
    first["process_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = _run_cli(cmd)
    again["process_s"] = time.perf_counter() - t0
    n_imgs = sum(len(list((ds / s / "images").glob("*.jpg"))) for s in ("train", "test"))
    ann = json.loads((ds / "corner_annotations.json").read_text())
    out["generate_dataset"] = {"first": first, "resume": again, "images_on_disk": n_imgs,
                               "annotated": sum(len(v) for v in ann.values()),
                               "yolo_labels": len(list((yolo / "train" / "labels")
                                                       .glob("*.txt")))}
    if first["written"] != 80 or again["written"] != 0 or again["skipped"] != 80 \
            or n_imgs != 80 or not out["generate_dataset"]["yolo_labels"]:
        bad.append(f"generate_dataset: {out['generate_dataset']}")
    # TTA card vs CPU
    imgs01 = torch.rand((8, 320, 240, 3), generator=torch.Generator().manual_seed(SEED + 701))
    card_t, cpu_t = tta_batch(imgs01.cuda()), tta_batch(imgs01)
    tta_err = {k: float((card_t[k].cpu() - cpu_t[k]).abs().max()) for k in cpu_t}
    out["tta_card_vs_cpu_max_abs"] = tta_err
    if not max(tta_err.values()) <= TTA_TOL:
        bad.append(f"tta_batch card vs CPU: {tta_err}")
    # the plot CLIs' computation
    rows = visualize_augmentations_torch.augmented_samples(4, 5, 160, 120, keypoints=True)
    batch = generate_examples_torch.annotation_batch(8, 320, 240)
    stats = generate_examples_torch.dataset_statistics()
    preds = generate_examples_torch.prediction_grid(str(seg_ck), batch["image"])
    cpu_preds = generate_examples_torch.prediction_grid(str(seg_ck), batch["image"],
                                                        device="cpu")
    pred_agree = float((preds["preds"] == cpu_preds["preds"]).mean())
    ok_rows = all(r["images"].shape == (5, 160, 120, 3) and 0 <= r["images"].min()
                  and r["images"].max() <= 1 and set(np.unique(r["masks"])) <= {0, 1}
                  for r in rows)
    out["plots"] = {"augmented_rows": len(rows), "rows_ok": ok_rows,
                    "stats": {"card": stats["card"], "negative": stats["negative"],
                              "mean_area_fraction": float(stats["area_fractions"].mean())},
                    "prediction_agreement_card_vs_cpu": pred_agree}
    if not ok_rows or stats["card"] + stats["negative"] != 256 \
            or not pred_agree >= ENTRY_AGREEMENT:
        bad.append(f"plots: {out['plots']}")
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    out["half_conv_layout"], faults = tools_conv_layout(torch)
    bad += faults
    out["slim_fixture"], slim_launches, faults = tools_slim_fixture(torch, root)
    bad += faults
    out["decode_fixtures"], chan_max, faults = tools_decode_fixtures(torch, root)
    bad += faults
    out["dead_channel"], faults = tools_dead_channel(torch, root, chan_max)
    bad += faults
    out["fixture_tools_seconds"] = time.perf_counter() - t_new
    emit({"phase": "tools", **out, "seconds": time.perf_counter() - t_start,
          "card": card["name"], "nvidia_smi": card["nvidia_smi"]})
    if bad:
        fail(f"tools: {bad}")
    return {"profile_blocks": launches, "slim_fixture_served": slim_launches["served"],
            "slim_fixture_profile": slim_launches["profile"]}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# profiled kernel-name fragments -> class, first match wins
PROFILE_CLASSES = (
    ("softmax (area attention, DFL; the loss's softmaxes)", ("softmax",)),
    ("optimizer (foreach AdamW)", ("multi_tensor_apply",)),
    ("batch norm, training (statistics, forward, backward)",
     ("batchnorm_fwtr", "batchnorm_bwtr", "bn_fw_tr", "bn_bw", "batch_norm_collect",
      "batch_norm_backward", "batch_norm_reduce", "batch_norm_elemt", "batch_norm_update")),
    ("tail chain: expand/project GEMM (pw_gemm_kernel)", ("pw_gemm_kernel",)),
    ("tail chain: depthwise + SE sums (depthwise_kernel)", ("depthwise_kernel",)),
    ("tail chain: SE gate (se_gate_kernel)", ("se_gate_kernel",)),
    ("stencil floor (stencil_floor_kernel)", ("stencil_floor_kernel",)),
    ("mask decode (mask_decode_kernel)", ("mask_decode_kernel",)),
    ("normalize (normalize_kernel)", ("normalize_kernel",)),
    ("stem (stem_kernel)", ("stem_kernel",)),
    ("head decode (head_decode_kernel)", ("head_decode_kernel",)),
    ("batch norm (cuDNN inference kernel)", ("bn_fw", "batch_norm", "batchnorm")),
    ("cuDNN layout transforms (tensorTransform)", ("tensortransform",)),
    # before the gathers: cuDNN's "implicit_gemm_indexed" kernels hold "index"
    ("cuDNN convolutions", ("conv", "xmma", "implicit", "cudnn", "nhwc", "dgrad", "wgrad",
                            "fprop")),
    ("gathers (nearest and bilinear resize, decode)", ("index", "gather")),
    ("cuBLAS / matmul", ("gemm", "cutlass", "cublas", "splitk")),
    ("reductions (SE/head pooling)", ("reduce",)),
    ("elementwise (bias, activations, casts, residuals)",
     ("elementwise", "vectorized", "unrolled")),
)


def profile_calls(torch, fn, calls: int) -> dict:
    """``torch.profiler`` over ``calls`` calls of ``fn``: device time by
    kernel class, the top kernels, and the device's busy and idle shares of
    the traced window (union of kernel intervals over first start to last
    end)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, without the device spans of annotated host ranges
    # (torch.optim's "Optimizer.step#AdamW.step"), which cover kernels
    # already counted
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
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
    return {"calls": calls, "wall_ms_per_call": wall_ms / calls,
            "kernel_ms_per_call": busy_us / 1e3 / calls,
            "kernel_launches_per_call": len(events) / calls,
            "device_busy_share": union / window_us,
            "device_idle_share": 1.0 - union / window_us,
            "classes": [{"class": lab, "ms_per_call": us / 1e3 / calls,
                         "share_of_kernel_time": us / busy_us}
                        for lab, us in sorted(per_class.items(), key=lambda kv: -kv[1])],
            "top_kernels": [{"name": n[:120], "ms_per_call": us / 1e3 / calls}
                            for n, us in top]}


def phase_profile(torch, pred, imgs, card, calls: int = 3):
    """Where the time of ``predict`` goes: ``profile_calls`` over a few
    calls of one main path's b128 predictor."""
    r = profile_calls(torch, lambda: pred.predict(imgs), calls)
    emit({"phase": "profile", "predictor": type(pred).__name__, "batch": imgs.shape[0],
          "size": list(imgs.shape[1:3]), **r,
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
        init_yolo_flax_like,
    )

    t_start = time.perf_counter()
    card = phase_env(torch)
    phase_build()
    weights = init_flax_like(SEED)
    rows = phase_kernels(torch, weights)
    launches, pred, imgs = phase_end_to_end(torch, weights, card)
    phase_profile(torch, pred, imgs, card)
    option_launches = phase_seg_options(torch, weights, pred, imgs, card)
    phase_seg_modes(torch, weights, pred, imgs, card)
    block_launches = phase_seg_fused_blocks(torch, weights, pred, imgs, card)
    del pred, imgs
    torch.cuda.empty_cache()
    phase_seg_320x240(torch, weights, card)
    pose_weights = init_hrnet_flax_like(SEED)
    pose_launches, pose_pred, pose_imgs = phase_pose_end_to_end(torch, pose_weights, card)
    phase_profile(torch, pose_pred, pose_imgs, card)
    del pose_pred, pose_imgs
    torch.cuda.empty_cache()
    yolo_weights = init_yolo_flax_like(SEED)
    phase_yolo(torch, yolo_weights, card)
    server_launches = phase_server(torch, weights, pose_weights, yolo_weights, card)
    stencil_launches = phase_stencil_tool(torch, card)
    phase_train(torch, weights, card)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ds_root = phase_data(torch, card, Path(tmp))
        cli_launches = phase_train_cli(torch, card, Path(tmp), ds_root)
        ce_launches = phase_compress_export(torch, card, Path(tmp), ds_root)
        pose_train_launches = phase_pose_pipeline(
            torch, card, Path(tmp), Path(tmp) / "ckpt_synthetic" / "final_model",
            Path(tmp) / "export_slim", Path(tmp) / "export_dense")
        phase_yolo_pipeline(torch, card, Path(tmp))
        dist_launches, dist_refs = phase_distributed(torch, card, Path(tmp))
        phase_space(torch, card, Path(tmp), dist_refs)
        tools_launches = phase_tools(torch, card, Path(tmp),
                                     Path(tmp) / "ckpt_synthetic" / "final_model")

    # per kernel: source, the TPU kernel it replaces, and its launches on
    # each main path that runs it, every path zeroed before and read after
    # its own run: the predictors' b128 runs and the server's 16 requests for
    # kernels 1, 2 and 4, the trained CLI checkpoint's b32 predict and the pruned,
    # slimmed one's for 1-2, the slim fixture's 512x512 b128 predict for 1-2
    # and its block profile for 1 and 4, the trained pose checkpoint's b24
    # predict for 4,
    # the per-block predictors' (fused_blocks=all at 512x512 b128 and
    # 320x240 b32, fused_chain=False) one predict each for 3, the option
    # predictors for 5-6, the stencil tool's run for 8 (upsample2x_add
    # has no caller in the package: its launches are those of the kernel
    # phase's timed run). ``launches`` is their sum.
    src, ref = f"{PKG}/csrc", "mtg_card_image_segmentation_tpu/ops/pallas"
    blocks_by_path = {"seg_predict_b128": sum(launches[n] for n in BLOCK_KERNELS),
                      "server": sum(server_launches[n] for n in BLOCK_KERNELS),
                      "train_cli_served": sum(cli_launches[n] for n in BLOCK_KERNELS),
                      "compress_export_served": sum(ce_launches[n] for n in BLOCK_KERNELS),
                      "distributed_served": sum(dist_launches[n] for n in BLOCK_KERNELS),
                      "slim_fixture_served": sum(tools_launches["slim_fixture_served"][n]
                                                 for n in BLOCK_KERNELS)}
    meta = {
        "fused_mask_decode": (f"{src}/decoder.cu", f"{ref}/decoder.py:190",
                              {"seg_predict_b128": launches["fused_mask_decode"],
                               "server": server_launches["fused_mask_decode"],
                               "train_cli_served": cli_launches["fused_mask_decode"],
                               "compress_export_served": ce_launches["fused_mask_decode"],
                               "distributed_served": dist_launches["fused_mask_decode"],
                               "profile_blocks": tools_launches["profile_blocks"][
                                   "fused_mask_decode"],
                               "slim_fixture_served": tools_launches["slim_fixture_served"][
                                   "fused_mask_decode"],
                               "slim_fixture_profile": tools_launches["slim_fixture_profile"][
                                   "fused_mask_decode"]}),
        "fused_inverted_residual": (f"{src}/fused_block.cu", f"{ref}/fused_block.py:515",
                                    block_launches),
        "fused_tail_chain": (f"{src}/fused_block.cu", f"{ref}/fused_block.py:393",
                             blocks_by_path),
        "fused_normalize": (f"{src}/preprocess.cu", f"{ref}/preprocess.py:37",
                            {"pose_predict_b128": pose_launches["fused_normalize"],
                             "server": server_launches["fused_normalize"],
                             "pose_train_served": pose_train_launches["fused_normalize"],
                             "profile_blocks": tools_launches["profile_blocks"][
                                 "fused_normalize"],
                             "slim_fixture_profile": tools_launches["slim_fixture_profile"][
                                 "fused_normalize"]}),
        "fused_stem": (f"{src}/stem.cu", f"{ref}/stem.py:186",
                       {"seg_options": option_launches["fused_stem"]}),
        "fused_head_decode": (f"{src}/decoder.cu", f"{ref}/decoder.py:122",
                              {"seg_options": option_launches["fused_head_decode"]}),
        "upsample2x_add": (f"{src}/decoder.cu", f"{ref}/decoder.py:58",
                           {"kernel_phase": rows["upsample2x_add"]["launches"]}),
        "stencil_floor": (f"{src}/stencil_floor.cu", "tools/vpu_stencil_floor.py:84",
                          {"stencil_tool": stencil_launches}),
    }
    kernels = []
    for name, (source, replaces, by_path) in meta.items():
        r = rows[name]
        idle = [path for path, n in by_path.items() if n <= 0]
        if idle:
            fail(f"{name} was launched no time on {idle}: {by_path}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
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
    if sys.argv[1:2] == ["distributed-worker"]:
        sys.exit(distributed_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["space-worker"]:
        sys.exit(space_worker(*sys.argv[2:]))
    sys.exit(main())
