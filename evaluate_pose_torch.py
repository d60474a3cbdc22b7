#!/usr/bin/env python
"""Corner-accuracy evaluation CLI of the PyTorch port for both pose families
(counterpart of ``evaluate_pose.py``; reference: python
train-pose-estimation_yolo12n/evaluate_model.py and the custom pipeline's
CornerMetrics reporting). Runs on the CUDA card; ``--device cpu`` runs on
the host.

Runs the model over held-out synthetic batches rendered on the device, each
from its own seed (5,000,000 + i: the JAX CLI's held-out keys, disjoint
from the training stream's seed; the renders are the port's own), and
emits the reference's report schema — accuracy@{3,5,6,10,20}px,
per-corner stats, detection rate, mean/median/std error, quality tiers
(*_yolo12n/README.md:163-171) — as pose_evaluation.json + report.txt +
error_distribution.png + accuracy_curve.png + worst-case panels. The plots
need matplotlib, which the evaluator imports only to draw them.

  python evaluate_pose_torch.py --family hrnet --checkpoint runs/pose/checkpoints/best_model
  python evaluate_pose_torch.py --family yolo --checkpoint runs/yolo/checkpoints/best_model --imgsz 640
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

HELD_OUT_SEED = 5_000_000


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--family", choices=["hrnet", "yolo"], required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--imgsz", type=int, default=640, help="yolo square input")
    parser.add_argument("--batches", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=24)
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    parser.add_argument(
        "--worst-k", type=int, default=8,
        help="save the k highest-error cases as GT-vs-pred corner panels",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mtg_card_image_segmentation_tpu_torch.config import pose_default_config
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch
    from mtg_card_image_segmentation_tpu_torch.evaluation import CornerEvaluator, PoseEvaluator
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.utils.params import hrnet_from_flax, yolo_from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg = pose_default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)
    out_dir = args.output_dir or f"runs/eval_{args.family}"

    # parameters and statistics only: no optimizer arrays are read
    ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
    params, batch_stats, meta = ckpt_lib.load_params(ckpt_dir or ".", name)
    print(f"loaded {args.checkpoint} (epoch {meta.get('epoch')})")
    dtype = getattr(torch, cfg.pose.compute_dtype)
    if args.family == "hrnet":
        h, w = cfg.pose.input_height, cfg.pose.input_width
        model = hrnet_from_flax(params, batch_stats,
                                (cfg.pose.heatmap_height, cfg.pose.heatmap_width), dtype=dtype)
        evaluator = PoseEvaluator(model.to(device), (h, w))
    else:
        h = w = args.imgsz
        evaluator = CornerEvaluator(yolo_from_flax(params, batch_stats, dtype=dtype).to(device),
                                    (h, w))

    def batches():
        for i in range(args.batches):
            gen = torch.Generator(device=device).manual_seed(HELD_OUT_SEED + i)
            s = synthetic_batch(gen, args.batch_size, h, w, 0.0, keep_in_frame=True)
            yield s.image, s.corners

    report = evaluator.evaluate(batches(), output_dir=out_dir, worst_k=args.worst_k)
    print(json.dumps({k: v for k, v in report.items() if k != "per_corner"}, indent=2))
    print(f"report -> {out_dir}/pose_evaluation.json")
    return report


if __name__ == "__main__":
    main()
