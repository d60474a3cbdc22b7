#!/usr/bin/env python
"""YOLO12n-pose ONNX export CLI of the PyTorch port (counterpart of
``export_yolo.py``; reference: ultralytics .export(format='onnx', opset 11,
simplify, dynamic, half) driven from
train-pose-estimation_yolo12n/model.py:266-310). Runs on the CUDA card;
``--device cpu`` runs on the host.

Creates a deployment package from a trained YOLO corner checkpoint:
  yolo.onnx          fp32 ONNX graph (BN folded, decode in-graph), opset 19
  yolo_fp16.onnx     fp16 weights, fp32 I/O
  yolo_int8.onnx     QDQ per-channel int8 conv weights (~4x smaller download)
  yolo_dynamic.onnx  fp32 with a symbolic batch axis (gated at b1 AND b4)
  yolo.pt2           torch.export ExportedProgram + .json sidecar (<1e-5
                     self-test) with the same output0, the counterpart of
                     the JAX CLI's yolo.stablehlo
  yolo_info.json     IO contract + parity results
  decode_yolo.py     the numpy client decode (export/yolo_client_decode.py)

Output contract: "output0" (1, 17, A), rows [x1,y1,x2,y2,score,
(kx,ky,kconf)x4] in input pixels (export/onnx_yolo.py). Every ONNX file is
run by the port's torch executor (export/onnx_torch_runner.py) on the
device and gated against ``YOLO12Pose(fold_bn=True)`` in float32 with the
JAX CLI's gates: fp32 max|diff| < 2e-3 px on a [0,1] noise probe; fp16
within 1 px on the pixel rows and 1e-2 on the probability rows; int8
functional, on a rendered card with known corners: the int8 graph's
client-decoded corner error against the ground truth may exceed the fp32
graph's by at most 2 px; the dynamic graph < 2e-3 at b1 and b4 (the JAX
CLI's mini-runtime gate; its torch re-execution, which allows 5e-3, is
this executor). The float32 graphs and the model run with TF32 and cuDNN
off (``utils/platform.py::ieee_fp32``), the fp16 graph in float16. A failed
gate exits 1.

  python export_yolo_torch.py --checkpoint runs/yolo/checkpoints/best_model
  python export_yolo_torch.py --checkpoint runs/yolo/checkpoints/best_model --info
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

INT8_PROBE_SEED = 11
ATOL32, ATOL16_PX, ATOL16_PROB, INT8_PX = 2e-3, 1.0, 1e-2, 2.0


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output-dir", default="exported_models_yolo")
    parser.add_argument("--imgsz", type=int, default=640)
    parser.add_argument("--skip-verify", action="store_true")
    parser.add_argument("--info", action="store_true",
                        help="print checkpoint info and exit")
    parser.add_argument(
        "--dynamic-batch", action=argparse.BooleanOptionalAction, default=True,
        help="also emit yolo_dynamic.onnx with a symbolic batch axis "
        "(the reference's ultralytics export defaults dynamic=True, "
        "model.py:266-310)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import shutil

    import torch

    from mtg_card_image_segmentation_tpu_torch.export import yolo_client_decode
    from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
    from mtg_card_image_segmentation_tpu_torch.export.onnx_export import convert_to_fp16
    from mtg_card_image_segmentation_tpu_torch.export.onnx_optimize import optimize
    from mtg_card_image_segmentation_tpu_torch.export.onnx_proto import independent_checks
    from mtg_card_image_segmentation_tpu_torch.export.onnx_yolo import export_yolo_model
    from mtg_card_image_segmentation_tpu_torch.export.quantize import convert_to_int8
    from mtg_card_image_segmentation_tpu_torch.export.torch_export import (
        YoloOutput0,
        export_program,
    )
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.utils.params import count_parameters, yolo_from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    size = args.imgsz
    anchors = sum((size // s) ** 2 for s in (8, 16, 32))
    # parameters and statistics only: no optimizer arrays are read
    ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
    params, batch_stats, meta = ckpt_lib.load_params(ckpt_dir or ".", name)
    if args.info:
        info = {"epoch": meta.get("epoch"), "best_metric": meta.get("best_metric"),
                "parameters": count_parameters(params),
                "input": [1, 3, size, size], "output0": [1, 17, anchors]}
        print(json.dumps(info, indent=2))
        return info
    print(f"loaded {args.checkpoint} (epoch {meta.get('epoch')})")

    folded = fold_batch_norm(params, batch_stats)
    onnx_model = export_yolo_model(folded, imgsz=size, opset=19)
    opt_stats = optimize(onnx_model)  # verified by the parity gates below
    if sum(opt_stats.values()):
        print(f"graph optimization: {opt_stats}")
    os.makedirs(args.output_dir, exist_ok=True)
    paths = {k: os.path.join(args.output_dir, f"yolo{suffix}.onnx")
             for k, suffix in (("fp32", ""), ("fp16", "_fp16"), ("int8", "_int8"),
                               ("dynamic", "_dynamic"))}
    onnx_model.save(paths["fp32"])
    print(f"yolo.onnx ({os.path.getsize(paths['fp32']) / 1e6:.1f} MB)")
    convert_to_fp16(onnx_model, keep_io_types=True).save(paths["fp16"])
    print(f"yolo_fp16.onnx ({os.path.getsize(paths['fp16']) / 1e6:.1f} MB, "
          f"{os.path.getsize(paths['fp32']) / os.path.getsize(paths['fp16']):.2f}x smaller)")
    convert_to_int8(onnx_model).save(paths["int8"])
    print(f"yolo_int8.onnx ({os.path.getsize(paths['int8']) / 1e6:.1f} MB, "
          f"{os.path.getsize(paths['fp32']) / os.path.getsize(paths['int8']):.2f}x smaller)")
    if args.dynamic_batch:
        dyn_model = export_yolo_model(folded, imgsz=size, opset=19, dynamic_batch=True)
        optimize(dyn_model)
        dyn_model.save(paths["dynamic"])
        print(f"yolo_dynamic.onnx ({os.path.getsize(paths['dynamic']) / 1e6:.1f} MB, "
              f"symbolic batch axis)")
    else:
        del paths["dynamic"]

    # fp32 compute for the parity reference (the deployed consumer is true
    # fp32), the inference layout the graph is written from
    model = yolo_from_flax(folded, None, dtype=torch.float32).to(device)
    # torch.export, the second serialization format (export_yolo.py writes
    # yolo.stablehlo): the folded fp32 model with the ONNX graph's output0
    program_info = export_program(YoloOutput0(model),
                                  (torch.zeros(1, 3, size, size, device=device),),
                                  os.path.join(args.output_dir, "yolo.pt2"))
    print(f"yolo.pt2 ({program_info['bytes'] / 1e6:.1f} MB, self-test "
          f"max|diff|={program_info['self_test_max_diff']:.2e} "
          f"{'PASS' if program_info['self_test_pass'] else 'FAIL'})")

    parity = {}
    if not args.skip_verify:
        from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op

        card, gt = int8_probe(size)
        parity = gates(model, {k: op.Model.load(p) for k, p in paths.items()}, device,
                       card, gt)
        parity.update(independent_checks(paths["fp32"]))
        if not all(v for k, v in _verdicts(parity).items()):
            raise SystemExit("parity gate FAILED")

    info = {
        "model": "yolo12n_pose",
        "input": {"name": "input", "shape": [1, 3, size, size],
                  "dtype": "float32", "normalization": "/255 only"},
        "output": {
            "name": "output0",
            "shape": [1, 17, anchors],
            "rows": "[x1,y1,x2,y2,score,(kx,ky,kconf)x4] in input pixels",
            "decode": "use decode_yolo.py (shipped alongside): joint decode "
                      "over 3 greedy-NMS peaks per corner channel with "
                      "collision penalty + canonical reordering — a naive "
                      "per-channel argmax regresses to corner-identity "
                      "swaps on ~2% of rotated cards",
        },
        "parameters": count_parameters(params),
        "opset": 19,
        "graph_optimization": opt_stats,
        "torch_export": program_info,
        "dynamic_batch_artifact": os.path.basename(paths["dynamic"]) if "dynamic" in paths
        else None,
        "checkpoint_epoch": meta.get("epoch"),
        "best_metric": meta.get("best_metric"),
        "parity": parity,
        "device": str(device),
    }
    with open(os.path.join(args.output_dir, "yolo_info.json"), "w") as f:
        json.dump(info, f, indent=2)
    # the raw graph output needs the joint corner decode to reach the
    # reported accuracy: ship the numpy client decode beside it
    shutil.copyfile(yolo_client_decode.__file__,
                    os.path.join(args.output_dir, "decode_yolo.py"))
    print(f"deployment package -> {args.output_dir}/")
    return info


def int8_probe(size: int):
    """The int8 gate's probe: one rendered card scene at ``size`` x
    ``size``, [0,1] NCHW float32, and its (4, 2) float64 corners (TL, TR,
    BR, BL), drawn on the host from a fixed seed (the same image on every
    device). No negative, corners in view: the probe holds a card."""
    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch

    gen = torch.Generator().manual_seed(INT8_PROBE_SEED)
    s = synthetic_batch(gen, 1, size, size, 0.0, keep_in_frame=True)
    image = np.ascontiguousarray(s.image.numpy().transpose(0, 3, 1, 2)).astype(np.float32)
    return image, s.corners[0].numpy().astype(np.float64)


def output0(boxes, scores, kpts):
    """Decoded (B, A, 4) boxes, (B, A, nc) scores and (B, A, K, 3)
    keypoints -> the graph's (B, 4 + nc + 3K, A) ``output0`` layout."""
    import numpy as np

    b = boxes.shape[0]
    kk = np.transpose(kpts, (0, 2, 3, 1)).reshape(b, -1, boxes.shape[1])
    return np.concatenate([np.moveaxis(boxes, 1, 2), np.moveaxis(scores, 1, 2), kk], axis=1)


def _verdicts(parity: dict) -> dict:
    v = {k: parity[f"{k}_pass"] for k in ("fp32", "fp16", "int8")}
    for name, r in parity.get("dynamic_batch", {}).items():
        v[f"dynamic {name.replace('batch', 'b')}"] = r["pass"]
    return v


def gates(model, graphs: dict, device, card, gt, seed: int = 0) -> dict:
    """The JAX CLI's parity gates on ``graphs`` ({"fp32", "fp16", "int8"[,
    "dynamic"]: parsed ONNX models}), each run by the torch executor on
    ``device`` against ``model`` (``YOLO12Pose(fold_bn=True)``, float32):
    [0,1] noise probes from ``numpy.random.default_rng(seed)`` (b1, and b1
    and b4 for the dynamic graph), the rendered ``card`` (1, 3, S, S) with
    its (4, 2) corners ``gt`` for int8. Prints each verdict and returns
    the readings with a ``<gate>_pass`` per gate."""
    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
    from mtg_card_image_segmentation_tpu_torch.export.yolo_client_decode import (
        decode as client_decode,
    )
    from mtg_card_image_segmentation_tpu_torch.utils.platform import ieee_fp32

    size = card.shape[2]
    runners = {k: make_runner(g, device) for k, g in graphs.items()}

    def run(name, x):
        return runners[name]({"input": x})["output0"]

    def reference(x_nchw):
        with torch.inference_mode():
            out = model(torch.from_numpy(np.ascontiguousarray(
                np.transpose(x_nchw, (0, 2, 3, 1)))).to(device))
        return output0(*(o.cpu().numpy() for o in out))

    rng = np.random.default_rng(seed)
    x_nchw = rng.random((1, 3, size, size)).astype(np.float32)
    probes = {nb: rng.random((nb, 3, size, size)).astype(np.float32)
              for nb in ((1, 4) if "dynamic" in graphs else ())}
    # the float32 graphs and the source model with the host's fp32 accuracy
    # (no TF32, no cuDNN), as export_yolo.py forces float32 precision around
    # its gates; the fp16 graph runs in float16
    with ieee_fp32():
        ref = reference(x_nchw)
        d32 = float(np.abs(run("fp32", x_nchw) - ref).max())
        ref_card, out8 = run("fp32", card), run("int8", card)
        dyn = {nb: float(np.abs(run("dynamic", xb) - reference(xb)).max())
               for nb, xb in probes.items()}
    ok32 = d32 < ATOL32
    print(f"fp32 parity: max|diff|={d32:.2e} (< {ATOL32}) {'PASS' if ok32 else 'FAIL'}")
    # per-row-type gates (a uniform 1 px would be vacuous for the [0,1]
    # probability rows): rows 0-3 box px, row 4 score, keypoint rows 5..
    # repeat (x px, y px, conf)
    diff16 = np.abs(run("fp16", x_nchw) - ref)
    n_rows = diff16.shape[1]
    prob_rows = [4] + [i for i in range(5, n_rows) if (i - 5) % 3 == 2]
    px_rows = [i for i in range(n_rows) if i not in prob_rows]
    d16_px, d16_prob = float(diff16[:, px_rows].max()), float(diff16[:, prob_rows].max())
    ok16 = d16_px <= ATOL16_PX and d16_prob <= ATOL16_PROB
    print(f"fp16 parity: px max|diff|={d16_px:.2e} (< {ATOL16_PX} px), "
          f"prob max|diff|={d16_prob:.2e} (< {ATOL16_PROB}) {'PASS' if ok16 else 'FAIL'}")
    # the int8 gate is functional and relative to the ground truth: on hard
    # poses the joint decode can collapse two corners onto one peak for one
    # graph and not the other, so a decode-vs-decode shift would read a
    # huge "diff" where the int8 decode is the better one
    err = {}
    for name, out in (("fp32", ref_card), ("int8", out8)):
        corners = np.asarray(client_decode(out)[2][:, :2], np.float64)
        err[name] = float(np.sqrt(((corners - gt) ** 2).sum(-1)).mean())
    ok8 = err["int8"] <= err["fp32"] + INT8_PX
    print(f"int8 parity: decoded corner error vs GT {err['int8']:.2f} px (fp32 graph: "
          f"{err['fp32']:.2f} px, gate <= +{INT8_PX:.0f}) {'PASS' if ok8 else 'FAIL'}")
    parity = {"fp32_max_abs_diff": d32, "fp32_pass": bool(ok32),
              "fp16_max_abs_diff": float(diff16.max()), "fp16_px_max_abs_diff": d16_px,
              "fp16_prob_max_abs_diff": d16_prob, "fp16_pass": bool(ok16),
              "int8_corner_err_vs_gt_px": err["int8"],
              "fp32_corner_err_vs_gt_px": err["fp32"], "int8_pass": bool(ok8)}
    if dyn:
        parity["dynamic_batch"] = {}
        for nb, d in dyn.items():
            okb = d < ATOL32
            parity["dynamic_batch"][f"batch{nb}"] = {"torch_runner_max_abs_diff": d,
                                                     "pass": bool(okb)}
            print(f"dynamic-batch parity b{nb}: max|diff|={d:.2e} {'PASS' if okb else 'FAIL'}")
    return parity


if __name__ == "__main__":
    main()
