#!/usr/bin/env python
"""Export CLI of the PyTorch port (counterpart of ``export_seg.py``;
reference: python train/export.py + onnx_fp16_converter.py). Runs on the
CUDA card; ``--device cpu`` runs on the host.

Creates a deployment package from a trained checkpoint:
  model.onnx          fp32 ONNX graph (BN folded), reference IO contract
  model_fp16.onnx     fp16 weights, fp32 I/O (the demo's model)
  model_int8.onnx     QDQ per-channel int8 weights
  model_dynamic.onnx  fp32 with a symbolic batch axis (gated at b1 AND b4)
  model.pt2           torch.export ExportedProgram + .json sidecar (<1e-5
                      self-test), the counterpart of the JAX CLI's
                      model.stablehlo
  params.npz          raw state-dict export
  model_info.json     IO contract + metrics + parity results
  README.md / inference_example.py

Every ONNX file is run by the port's torch executor
(export/onnx_torch_runner.py) on the device and gated against the source
model (the float32 graphs with TF32 and cuDNN off, the fp16 graph in
float16 on cuDNN) with the reference's gates (fp32 max|diff| < 1e-4,
train/export.py:159-162; fp16 in probability space; int8 mask agreement
>= 0.999); a failed gate exits non-zero.

  python export_seg_torch.py --checkpoint ckpts/best_model --output-dir exported_models
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

_README = """# Card Segmentation — deployment package

Exported by mtg_card_image_segmentation_tpu_torch (LR-ASPP
MobileNetV3-Large, BatchNorm folded).

## Contract
- input  "input":  (1, 3, {H}, {W}) float32, RGB, ImageNet-normalized
  (mean [0.485, 0.456, 0.406], std [0.229, 0.224, 0.225]), NCHW
- output "output": (1, {C}, {H}, {W}) float32 logits; argmax over channel
  1 = card, 0 = background

## Files
- model.onnx          fp32
- model_fp16.onnx     fp16 weights, fp32 I/O (use this in ONNX Runtime Web)
- model_int8.onnx     int8 QDQ weights
- model_dynamic.onnx  fp32 with a symbolic batch axis (server batching)
- model.pt2           torch.export ExportedProgram (+ .json sidecar), fp32,
                      batch 1: torch.export.load("model.pt2").module()(x)
- params.npz          flat state-dict (numpy)
- model_info.json     details + parity verification results

See inference_example.py for a minimal consumer.
"""

_EXAMPLE = """import numpy as np
# minimal consumer using any ONNX runtime:
#   session = onnxruntime.InferenceSession("model_fp16.onnx")
img = np.random.rand(1, 3, {H}, {W}).astype(np.float32)
mean = np.array([0.485, 0.456, 0.406], np.float32).reshape(1, 3, 1, 1)
std = np.array([0.229, 0.224, 0.225], np.float32).reshape(1, 3, 1, 1)
x = (img - mean) / std
# out = session.run(["output"], {{"input": x}})[0]
# mask = out.argmax(axis=1).astype(np.uint8)
"""


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output-dir", default="exported_models")
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    parser.add_argument("--skip-verify", action="store_true")
    parser.add_argument(
        "--dynamic-batch", action=argparse.BooleanOptionalAction, default=True,
        help="also emit model_dynamic.onnx with a symbolic batch axis "
        "(dim_param), parity-gated at batch 1 AND 4 (the reference's "
        "dynamic_axes, train/export.py:68-79)",
    )
    parser.add_argument(
        "--slim", action="store_true",
        help="physically remove dead (expansion-pruned) channels before "
        "export — smaller AND faster artifact, exact-parity "
        "(train/prune.py:102-113 mask removal, made real)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.config import default_config
    from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
    from mtg_card_image_segmentation_tpu_torch.export.onnx_export import (
        convert_to_fp16,
        export_seg_model,
    )
    from mtg_card_image_segmentation_tpu_torch.export.onnx_optimize import optimize
    from mtg_card_image_segmentation_tpu_torch.export.onnx_proto import independent_checks
    from mtg_card_image_segmentation_tpu_torch.export.quantize import convert_to_int8
    from mtg_card_image_segmentation_tpu_torch.export.torch_export import NCHW, export_program
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.utils.params import count_parameters, from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import no_tf32, resolve_device

    device = resolve_device(args.device)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg = default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)
    h, w = cfg.model.input_height, cfg.model.input_width

    ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
    params, batch_stats, meta = ckpt_lib.load_params(ckpt_dir or ".", name)
    print(f"loaded {args.checkpoint} (epoch {meta.get('epoch')})")

    slim_overrides = None
    if args.slim:
        from mtg_card_image_segmentation_tpu_torch.compression.slim import (
            dead_expansion_channels,
            param_count,
            slim_seg_state,
        )

        dead = dead_expansion_channels(params)
        n_dead = sum(v.size for v in dead.values())
        if n_dead == 0:
            print("--slim: no dead expansion channels found (run "
                  "prune_seg_torch.py --method expansion first); exporting dense")
        else:
            full_n = param_count(params)
            params, batch_stats, slim_overrides = slim_seg_state(params, batch_stats)
            print(
                f"--slim: removed {n_dead} expansion channels across "
                f"{len(dead)} blocks; params {full_n:,} -> "
                f"{param_count(params):,} "
                f"({param_count(params) / full_n:.1%})"
            )
    # the fp32 source model (BN unfolded, widths read from the tree)
    model = from_flax(params, batch_stats, dtype=torch.float32).to(device)

    seconds = {}
    t0 = time.perf_counter()
    folded = fold_batch_norm(params, batch_stats)
    onnx_model = export_seg_model(
        folded, input_hw=(h, w), num_classes=cfg.model.num_classes,
        inter_channels=cfg.model.inter_channels, opset=cfg.export.opset,
    )
    # graph-optimization pass (train/export.py:102-129 runs onnxoptimizer);
    # downstream fp16/int8 conversions and every parity gate below see the
    # optimized graph, so the simplification is itself verified
    opt_stats = optimize(onnx_model)
    n_opt = sum(opt_stats.values())
    if n_opt:
        print(f"graph optimization: {opt_stats}")
    os.makedirs(args.output_dir, exist_ok=True)
    fp32_path = os.path.join(args.output_dir, "model.onnx")
    onnx_model.save(fp32_path)
    seconds["model.onnx"] = time.perf_counter() - t0
    print(f"model.onnx ({os.path.getsize(fp32_path) / 1e6:.1f} MB)")

    t0 = time.perf_counter()
    fp16_model = convert_to_fp16(onnx_model, keep_io_types=cfg.export.keep_io_types)
    fp16_path = os.path.join(args.output_dir, "model_fp16.onnx")
    fp16_model.save(fp16_path)
    seconds["model_fp16.onnx"] = time.perf_counter() - t0
    print(f"model_fp16.onnx ({os.path.getsize(fp16_path) / 1e6:.1f} MB, "
          f"{os.path.getsize(fp32_path) / os.path.getsize(fp16_path):.2f}x smaller)")

    # int8 QDQ export: per-output-channel symmetric weight quantization +
    # DequantizeLinear
    t0 = time.perf_counter()
    int8_model = convert_to_int8(onnx_model)
    int8_path = os.path.join(args.output_dir, "model_int8.onnx")
    int8_model.save(int8_path)
    seconds["model_int8.onnx"] = time.perf_counter() - t0
    print(f"model_int8.onnx ({os.path.getsize(int8_path) / 1e6:.1f} MB, "
          f"{os.path.getsize(fp32_path) / os.path.getsize(int8_path):.2f}x smaller)")

    dyn_path = None
    if args.dynamic_batch:
        t0 = time.perf_counter()
        dyn_model = export_seg_model(
            folded, input_hw=(h, w), num_classes=cfg.model.num_classes,
            inter_channels=cfg.model.inter_channels, opset=cfg.export.opset,
            dynamic_batch=True,
        )
        optimize(dyn_model)
        dyn_path = os.path.join(args.output_dir, "model_dynamic.onnx")
        dyn_model.save(dyn_path)
        seconds["model_dynamic.onnx"] = time.perf_counter() - t0
        print(f"model_dynamic.onnx ({os.path.getsize(dyn_path) / 1e6:.1f} MB, "
              f"symbolic batch axis)")

    # torch.export, the second serialization format (the reference ships
    # TorchScript beside ONNX with its own <1e-5 gate, train/export.py:167-244;
    # export_seg.py writes model.stablehlo): the unfolded fp32 model, NCHW
    t0 = time.perf_counter()
    program_info = export_program(NCHW(model), (torch.zeros(1, 3, h, w, device=device),),
                                  os.path.join(args.output_dir, "model.pt2"))
    seconds["model.pt2"] = time.perf_counter() - t0
    print(f"model.pt2 ({program_info['bytes'] / 1e6:.1f} MB, self-test "
          f"max|diff|={program_info['self_test_max_diff']:.2e} "
          f"{'PASS' if program_info['self_test_pass'] else 'FAIL'})")

    # state-dict export (train/export.py:246-280): the same flat keys as
    # the JAX CLI ("params/backbone/stem/conv/kernel", ...)
    flat = ckpt_lib.flatten_tree({"params": params, "batch_stats": batch_stats})
    np.savez_compressed(os.path.join(args.output_dir, "params.npz"), **flat)
    print(f"export seconds {json.dumps(seconds)}")

    parity = {}
    if not args.skip_verify:
        with no_tf32():
            parity = _gates(cfg, model, device, onnx_model, fp16_model,
                            fp32_path, fp16_path, int8_path, dyn_path)
        parity.update(independent_checks(fp32_path))

    info = {
        "model": cfg.model.name,
        "input": {"name": "input", "shape": [1, 3, h, w], "dtype": "float32",
                  "normalization": "ImageNet"},
        "output": {"name": "output", "shape": [1, cfg.model.num_classes, h, w],
                   "classes": ["background", "card"]},
        "parameters": count_parameters(params),
        "slimmed_expansions": list(slim_overrides) if slim_overrides else None,
        "opset": cfg.export.opset,
        "checkpoint_epoch": meta.get("epoch"),
        "best_metric": meta.get("best_metric"),
        "graph_optimization": opt_stats,
        "torch_export": program_info,
        "dynamic_batch_artifact": os.path.basename(dyn_path) if dyn_path else None,
        "parity": parity,
        "device": str(device),
    }
    with open(os.path.join(args.output_dir, "model_info.json"), "w") as f:
        json.dump(info, f, indent=2)
    with open(os.path.join(args.output_dir, "README.md"), "w") as f:
        f.write(_README.format(H=h, W=w, C=cfg.model.num_classes))
    with open(os.path.join(args.output_dir, "inference_example.py"), "w") as f:
        f.write(_EXAMPLE.format(H=h, W=w))
    print(f"deployment package -> {args.output_dir}/")
    return info


def gate_probes(h: int, w: int) -> dict:
    """The float32 gates' NCHW inputs, in the order export_seg.py draws
    them from ``numpy.random.default_rng(0)``: ``fp32`` (b1), then
    ``dynamic b1`` and ``dynamic b4``."""
    import numpy as np

    rng = np.random.default_rng(0)
    return {g: rng.standard_normal((nb, 3, h, w)).astype(np.float32)
            for g, nb in (("fp32", 1), ("dynamic b1", 1), ("dynamic b4", 4))}


def _gates(cfg, model, device, onnx_model, fp16_model, fp32_path, fp16_path,
           int8_path, dyn_path) -> dict:
    """The parity gates, each ONNX file run by the torch executor on
    ``device``; raises SystemExit when one fails."""
    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
    from mtg_card_image_segmentation_tpu_torch.export.onnx_export import auto_mixed_precision
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
    from mtg_card_image_segmentation_tpu_torch.utils.platform import ieee_fp32

    h, w = cfg.model.input_height, cfg.model.input_width

    def reference(x_nchw):
        with torch.inference_mode():
            out = model(torch.from_numpy(np.ascontiguousarray(
                np.transpose(x_nchw, (0, 2, 3, 1)))).to(device))
        return np.transpose(out.cpu().numpy(), (0, 3, 1, 2))

    def run(path_or_model, x):
        m = op.Model.load(path_or_model) if isinstance(path_or_model, str) else path_or_model
        return make_runner(m, device)({"input": x})["output"]

    drawn = gate_probes(h, w)
    x_nchw = drawn["fp32"]
    probes = {nb: drawn[f"dynamic b{nb}"] for nb in ((1, 4) if dyn_path else ())}
    # the float32 graphs and the source model run with the host's fp32
    # accuracy (no TF32, no cuDNN), as export_seg.py forces float32
    # precision around its gates; the fp16 graph runs on cuDNN in float16,
    # as a deployment runtime runs it
    with ieee_fp32():
        ref_nchw = reference(x_nchw)
        out32 = run(fp32_path, x_nchw)
        out8 = run(int8_path, x_nchw)
        if dyn_path:
            dyn_run = make_runner(op.Model.load(dyn_path), device)
            dyn_diff = {nb: float(np.abs(dyn_run({"input": xb})["output"]
                                         - reference(xb)).max())
                        for nb, xb in probes.items()}
    d32 = float(np.abs(out32 - ref_nchw).max())
    ok32 = d32 < cfg.export.parity_atol_fp32
    print(f"fp32 parity: max|diff|={d32:.2e} (< {cfg.export.parity_atol_fp32}) "
          f"{'PASS' if ok32 else 'FAIL'}")
    # fp16 gate in PROBABILITY space: the artifact's consumer argmaxes
    # the logits (demo/src/image-utils.js:167-180), so what must hold
    # is the class decision, not logit bits. A logit-space rtol gate is
    # brittle exactly where it matters least (near-zero logits far from
    # the decision boundary, which softmax squashes). Criterion:
    # max|softmax Δ| <= parity_rtol_fp16 (1e-2) and pixel mask
    # agreement >= 99.99%.
    tol_prob = cfg.export.parity_rtol_fp16

    def _probs(logits):
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    ref_probs = _probs(ref_nchw)
    ref_mask = ref_nchw.argmax(axis=1)

    def gate16():
        out16 = run(fp16_path, x_nchw)
        d = float(np.abs(out16 - ref_nchw).max())
        dp = float(np.abs(_probs(out16) - ref_probs).max())
        agree = float((out16.argmax(axis=1) == ref_mask).mean())
        fine = bool(dp <= tol_prob and agree >= 0.9999)
        return fine, d, dp, agree

    ok16, d16, dp16, agree16 = gate16()
    n_fp16 = len(fp16_model.nodes)
    if not ok16:
        # fall back to mixed precision, keeping the smallest fp32 graph
        # suffix that restores the probability tolerance (the
        # reference's auto_convert_mixed_precision behavior,
        # export_onnx.py:99-107)
        print(f"fp16 parity: prob max|diff|={dp16:.2e} mask agreement={agree16:.6f} "
              "outside the gate; searching a mixed-precision graph")
        fp16_model, n_fp16 = auto_mixed_precision(
            onnx_model, ref_probs, lambda m: _probs(run(m, x_nchw)),
            rtol=0.0, atol=tol_prob,
        )
        fp16_model.save(fp16_path)
        print(f"model_fp16.onnx rewritten mixed-precision "
              f"({os.path.getsize(fp16_path) / 1e6:.1f} MB, "
              f"{n_fp16}/{len(onnx_model.nodes)} nodes fp16)")
        ok16, d16, dp16, agree16 = gate16()
    print(f"fp16 parity: logits max|diff|={d16:.2e} prob max|diff|={dp16:.2e} "
          f"mask agreement={agree16:.6f} {'PASS' if ok16 else 'FAIL'}")
    parity = {
        "fp32_max_abs_diff": d32, "fp32_pass": bool(ok32),
        "fp16_max_abs_diff": d16, "fp16_prob_max_abs_diff": dp16,
        "fp16_mask_agreement": agree16, "fp16_pass": bool(ok16),
        "fp16_nodes": n_fp16, "total_nodes": len(onnx_model.nodes),
    }
    # int8 gate: the quantized weights must preserve the class decision
    # — pixel mask agreement >= 99.9% vs the fp32 graph
    agree8 = float((out8.argmax(axis=1) == ref_mask).mean())
    dp8 = float(np.abs(_probs(out8) - ref_probs).max())
    ok8 = agree8 >= 0.999
    print(f"int8 parity: prob max|diff|={dp8:.2e} "
          f"mask agreement={agree8:.6f} (>= 0.999) {'PASS' if ok8 else 'FAIL'}")
    parity.update({
        "int8_prob_max_abs_diff": dp8,
        "int8_mask_agreement": agree8,
        "int8_pass": bool(ok8),
    })
    # dynamic-batch gate: ONE artifact at batch 1 AND 4
    okdyn = True
    if dyn_path:
        dyn_results = {}
        for nb, d in dyn_diff.items():
            okb = d < cfg.export.parity_atol_fp32
            okdyn = okdyn and okb
            dyn_results[f"batch{nb}"] = {"torch_runner_max_abs_diff": d, "pass": bool(okb)}
            print(f"dynamic-batch parity b{nb}: max|diff|={d:.2e} {'PASS' if okb else 'FAIL'}")
        parity["dynamic_batch"] = dyn_results
    if not (ok32 and ok16 and ok8 and okdyn):
        raise SystemExit("parity gate FAILED")
    return parity


if __name__ == "__main__":
    main()
