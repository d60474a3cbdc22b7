#!/usr/bin/env python
"""Pose (HRNet heatmap) ONNX export CLI of the PyTorch port (counterpart of
``export_pose.py``; reference: python
train-pose-estimation_custom/export_onnx.py). Runs on the CUDA card;
``--device cpu`` runs on the host.

Creates a deployment package from a trained pose checkpoint:
  pose.onnx          fp32 ONNX graph (BN folded), opset 19
  pose_fp16.onnx     fp16 weights, fp32 I/O
  pose_int8.onnx     QDQ per-channel int8 weights (~4x smaller download)
  pose_dynamic.onnx  fp32 with a symbolic batch axis (gated at b1 AND b4)
  pose.pt2           torch.export ExportedProgram + .json sidecar (<1e-5
                     self-test), the counterpart of the JAX CLI's
                     pose.stablehlo
  pose_info.json     IO contract + parity results

Every ONNX file is run by the port's torch executor
(export/onnx_torch_runner.py) on the device and gated against the source
model (fp32 compute), with the JAX CLI's gates: fp32 max|diff| < 1e-4 on a
[0,1] noise probe; fp16 within atol 1e-3 + rtol 1e-2 (the reference's
auto_convert_mixed_precision tolerance, export_onnx.py:104); int8 decoded
corner peaks moved by at most one heatmap pixel against the fp32 graph on
a rendered card; the dynamic graph < 1e-4 at b1 and b4. The float32 graphs
run with TF32 and cuDNN off (``utils/platform.py::ieee_fp32``), the fp16
graph in float16. A failed gate exits 1.

  python export_pose_torch.py --checkpoint runs/pose/checkpoints/best_model
  python export_pose_torch.py --checkpoint runs/pose/checkpoints/best_model --info
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

INT8_PROBE_SEED = 11


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output-dir", default="exported_models_pose")
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    parser.add_argument("--skip-verify", action="store_true")
    parser.add_argument("--info", action="store_true",
                        help="print checkpoint info and exit (export_onnx.py --info)")
    parser.add_argument(
        "--dynamic-batch", action=argparse.BooleanOptionalAction, default=True,
        help="also emit pose_dynamic.onnx with a symbolic batch axis "
        "(the reference exports dynamic batch by default, "
        "export_onnx.py:74-95)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mtg_card_image_segmentation_tpu_torch.config import pose_default_config
    from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
    from mtg_card_image_segmentation_tpu_torch.export.onnx_export import (
        convert_to_fp16,
        export_pose_model,
    )
    from mtg_card_image_segmentation_tpu_torch.export.onnx_optimize import optimize
    from mtg_card_image_segmentation_tpu_torch.export.onnx_proto import independent_checks
    from mtg_card_image_segmentation_tpu_torch.export.quantize import convert_to_int8
    from mtg_card_image_segmentation_tpu_torch.export.torch_export import NCHW, export_program
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.utils.params import count_parameters, hrnet_from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg = pose_default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)
    h, w = cfg.pose.input_height, cfg.pose.input_width
    hm_h, hm_w = cfg.pose.heatmap_height, cfg.pose.heatmap_width
    k = cfg.pose.num_keypoints

    # parameters and statistics only: no optimizer arrays are read
    ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
    params, batch_stats, meta = ckpt_lib.load_params(ckpt_dir or ".", name)
    if args.info:
        info = {"epoch": meta.get("epoch"), "best_metric": meta.get("best_metric"),
                "parameters": count_parameters(params),
                "input": [1, 3, h, w], "heatmaps": [1, k, hm_h, hm_w]}
        print(json.dumps(info, indent=2))
        return info
    print(f"loaded {args.checkpoint} (epoch {meta.get('epoch')})")
    # fp32 compute for the parity reference (the deployed consumer is true fp32)
    model = hrnet_from_flax(params, batch_stats, (hm_h, hm_w), dtype=torch.float32).to(device)

    folded = fold_batch_norm(params, batch_stats)
    onnx_model = export_pose_model(folded, input_hw=(h, w), heatmap_hw=(hm_h, hm_w),
                                   num_keypoints=k, opset=19)
    opt_stats = optimize(onnx_model)  # verified by the parity gates below
    if sum(opt_stats.values()):
        print(f"graph optimization: {opt_stats}")
    os.makedirs(args.output_dir, exist_ok=True)
    fp32_path = os.path.join(args.output_dir, "pose.onnx")
    onnx_model.save(fp32_path)
    print(f"pose.onnx ({os.path.getsize(fp32_path) / 1e6:.1f} MB)")

    fp16_path = os.path.join(args.output_dir, "pose_fp16.onnx")
    convert_to_fp16(onnx_model, keep_io_types=True).save(fp16_path)
    print(f"pose_fp16.onnx ({os.path.getsize(fp16_path) / 1e6:.1f} MB, "
          f"{os.path.getsize(fp32_path) / os.path.getsize(fp16_path):.2f}x smaller)")

    # int8 QDQ export: per-output-channel symmetric weight quantization +
    # DequantizeLinear nodes
    int8_path = os.path.join(args.output_dir, "pose_int8.onnx")
    convert_to_int8(onnx_model).save(int8_path)
    print(f"pose_int8.onnx ({os.path.getsize(int8_path) / 1e6:.1f} MB, "
          f"{os.path.getsize(fp32_path) / os.path.getsize(int8_path):.2f}x smaller)")

    dyn_path = None
    if args.dynamic_batch:
        dyn_model = export_pose_model(folded, input_hw=(h, w), heatmap_hw=(hm_h, hm_w),
                                      num_keypoints=k, opset=19, dynamic_batch=True)
        optimize(dyn_model)
        dyn_path = os.path.join(args.output_dir, "pose_dynamic.onnx")
        dyn_model.save(dyn_path)
        print(f"pose_dynamic.onnx ({os.path.getsize(dyn_path) / 1e6:.1f} MB, "
              f"symbolic batch axis)")

    # torch.export, the second serialization format (export_pose.py writes
    # pose.stablehlo): the unfolded fp32 model, NCHW in, NCHW heatmaps out
    program_info = export_program(NCHW(model), (torch.zeros(1, 3, h, w, device=device),),
                                  os.path.join(args.output_dir, "pose.pt2"))
    print(f"pose.pt2 ({program_info['bytes'] / 1e6:.1f} MB, self-test "
          f"max|diff|={program_info['self_test_max_diff']:.2e} "
          f"{'PASS' if program_info['self_test_pass'] else 'FAIL'})")

    parity = {}
    if not args.skip_verify:
        parity = _gates(cfg, model, device, fp32_path, fp16_path, int8_path, dyn_path)
        parity.update(independent_checks(fp32_path))

    info = {
        "model": cfg.pose.name,
        "input": {"name": "input", "shape": [1, 3, h, w], "dtype": "float32",
                  "normalization": "/255 only (no ImageNet normalization)"},
        "output": {
            "name": "heatmaps", "shape": [1, k, hm_h, hm_w],
            "decode": "per-channel argmax -> (x, y); for the reported "
                      "sub-pixel accuracy refine each peak by the "
                      "quadratic fit x += 0.5*(f[x+1]-f[x-1]) / "
                      "(2f[x]-f[x+1]-f[x-1]) per axis (interior peaks "
                      "only), then scale by (input_size-1)/(heatmap_size-1)",
            "robustness": "if exactly one channel's peak value is < 0.2 "
                          "while the other three are > 0.5 (a dead "
                          "channel), reconstruct that corner as the "
                          "parallelogram completion c[k] = c[k+1] + "
                          "c[k-1] - c[k+2] of the live corners "
                          "(ops/heatmap.py complete_dead_corner)",
        },
        "parameters": count_parameters(params),
        "opset": 19,
        "graph_optimization": opt_stats,
        "torch_export": program_info,
        "dynamic_batch_artifact": os.path.basename(dyn_path) if dyn_path else None,
        "checkpoint_epoch": meta.get("epoch"),
        "best_metric": meta.get("best_metric"),
        "parity": parity,
        "device": str(device),
    }
    with open(os.path.join(args.output_dir, "pose_info.json"), "w") as f:
        json.dump(info, f, indent=2)
    print(f"deployment package -> {args.output_dir}/")
    return info


def int8_probe(h: int, w: int):
    """The int8 gate's probe: one rendered card scene at (h, w), [0,1]
    NCHW float32, drawn on the host from a fixed seed (the same image on
    every device). No negative, corners in view: the probe holds a card."""
    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch

    gen = torch.Generator().manual_seed(INT8_PROBE_SEED)
    image = synthetic_batch(gen, 1, h, w, 0.0, keep_in_frame=True).image
    return np.ascontiguousarray(image.numpy().transpose(0, 3, 1, 2)).astype(np.float32)


def peaks(hms):
    """(1, K, H, W) heatmaps -> (K, 2) integer [x, y] of each channel's
    first maximum."""
    import numpy as np

    kk = hms.shape[1]
    flat = hms.reshape(kk, -1).argmax(-1)
    return np.stack([flat % hms.shape[3], flat // hms.shape[3]], -1)


def _gates(cfg, model, device, fp32_path, fp16_path, int8_path, dyn_path) -> dict:
    """The parity gates, each ONNX file run by the torch executor on
    ``device``; raises SystemExit when one fails."""
    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import (
        make_runner,
        run_model,
    )
    from mtg_card_image_segmentation_tpu_torch.utils.platform import ieee_fp32

    h, w = cfg.pose.input_height, cfg.pose.input_width
    ex = cfg.export

    def reference(x_nchw):
        with torch.inference_mode():
            out = model(torch.from_numpy(np.ascontiguousarray(
                np.transpose(x_nchw, (0, 2, 3, 1)))).to(device))
        return np.transpose(out.cpu().numpy(), (0, 3, 1, 2))

    def run(path, x):
        return run_model(op.Model.load(path), {"input": x}, device)["heatmaps"]

    rng = np.random.default_rng(0)
    x_nchw = rng.random((1, 3, h, w)).astype(np.float32)  # [0,1] domain
    probes = {nb: rng.random((nb, 3, h, w)).astype(np.float32)
              for nb in ((1, 4) if dyn_path else ())}
    card = int8_probe(h, w)
    # the float32 graphs and the source model with the host's fp32
    # accuracy (no TF32, no cuDNN), as export_pose.py forces float32
    # precision around its gates; the fp16 graph runs in float16
    with ieee_fp32():
        ref_nchw = reference(x_nchw)
        out32 = run(fp32_path, x_nchw)
        ref_card = run(fp32_path, card)
        out8 = run(int8_path, card)
        if dyn_path:
            dyn_run = make_runner(op.Model.load(dyn_path), device)
            dyn_diff = {nb: float(np.abs(dyn_run({"input": xb})["heatmaps"]
                                         - reference(xb)).max())
                        for nb, xb in probes.items()}
    d32 = float(np.abs(out32 - ref_nchw).max())
    ok32 = d32 < ex.parity_atol_fp32
    print(f"fp32 parity: max|diff|={d32:.2e} (< {ex.parity_atol_fp32}) "
          f"{'PASS' if ok32 else 'FAIL'}")
    out16 = run(fp16_path, x_nchw)
    d16 = float(np.abs(out16 - ref_nchw).max())
    ok16 = bool(np.all(np.abs(out16 - ref_nchw)
                       <= ex.parity_atol_fp16 + ex.parity_rtol_fp16 * np.abs(ref_nchw)))
    print(f"fp16 parity: max|diff|={d16:.2e} {'PASS' if ok16 else 'FAIL'}")
    # the int8 gate is functional, on a rendered card (heatmap peaks on a
    # noise probe are arbitrary): the decoded peaks of the int8 graph may
    # move by one heatmap pixel at most against the fp32 graph, both run by
    # the same executor, which isolates the quantization error
    shift8 = float(np.abs(peaks(out8) - peaks(ref_card)).max())
    d8 = float(np.abs(out8 - ref_card).max())
    ok8 = shift8 <= 1.0
    print(f"int8 parity: heatmap max|diff|={d8:.2e}, peak shift={shift8:.0f} hm-px (<= 1) "
          f"{'PASS' if ok8 else 'FAIL'}")
    parity = {
        "fp32_max_abs_diff": d32, "fp32_pass": bool(ok32),
        "fp16_max_abs_diff": d16, "fp16_pass": bool(ok16),
        "int8_max_abs_diff": d8, "int8_peak_shift_hm_px": shift8, "int8_pass": bool(ok8),
    }
    okdyn = True
    if dyn_path:
        dyn_results = {}
        for nb, d in dyn_diff.items():
            okb = d < ex.parity_atol_fp32
            okdyn = okdyn and okb
            dyn_results[f"batch{nb}"] = {"torch_runner_max_abs_diff": d, "pass": bool(okb)}
            print(f"dynamic-batch parity b{nb}: max|diff|={d:.2e} {'PASS' if okb else 'FAIL'}")
        parity["dynamic_batch"] = dyn_results
    if not (ok32 and ok16 and ok8 and okdyn):
        raise SystemExit("parity gate FAILED")
    return parity


if __name__ == "__main__":
    main()
