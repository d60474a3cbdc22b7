#!/usr/bin/env python
"""Segmentation evaluation CLI of the PyTorch port (counterpart of
``evaluate_seg.py``; reference: python train/evaluate.py). Runs on the CUDA
card; ``--device cpu`` runs on the host.

  python evaluate_seg_torch.py --checkpoint ckpts/best_model --source synthetic \\
      --batches 10 --save-plots --output-dir eval_out

Writes ``<output-dir>/evaluation_report.json`` and, for mined failures and
the worst-k cases (or with ``--save-plots``), matplotlib panels under
``<output-dir>/failures/``; pass ``--failure-threshold 0 --worst-k 0`` on a
host without matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True, help="checkpoint dir (e.g. ckpts/best_model)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    parser.add_argument("--source", choices=["synthetic", "files"], default="synthetic")
    parser.add_argument("--batches", type=int, default=10, help="synthetic eval batches")
    parser.add_argument("--output-dir", default="eval_out")
    parser.add_argument("--save-plots", action="store_true")
    parser.add_argument("--failure-threshold", type=float, default=0.5)
    parser.add_argument(
        "--worst-k", type=int, default=8,
        help="save the k lowest-IoU cases as panels even above the threshold",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mtg_card_image_segmentation_tpu_torch.config import Config, default_config
    from mtg_card_image_segmentation_tpu_torch.evaluation import SegEvaluator
    from mtg_card_image_segmentation_tpu_torch.models import registry
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.utils.params import flax_to_state_dict
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg = Config.from_json(args.config) if args.config else default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)
    h, w = cfg.model.input_height, cfg.model.input_width
    batch = cfg.data.batch_size

    # parameters and statistics only: no optimizer arrays are read
    ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
    params, batch_stats, meta = ckpt_lib.load_params(ckpt_dir or ".", name)
    model = registry.from_config(cfg.model)
    model.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)
    model = model.to(device).eval()
    print(f"loaded {args.checkpoint} (epoch {meta.get('epoch')})")

    if args.source == "synthetic":
        from mtg_card_image_segmentation_tpu_torch.data.preprocess import normalize_only
        from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch

        def make_batch(seed: int):
            b = synthetic_batch(torch.Generator(device=device).manual_seed(seed), batch, h, w)
            return normalize_only(b.image), b.mask

        batches = [make_batch(7_000_000 + i) for i in range(args.batches)]
    else:
        from mtg_card_image_segmentation_tpu_torch.data.dataset import CardSegmentationDataset
        from mtg_card_image_segmentation_tpu_torch.data.pipeline import FilePipeline

        root = cfg.data.dataset_root
        ds = CardSegmentationDataset(
            os.path.join(root, cfg.data.test_split, "images"),
            os.path.join(root, cfg.data.test_split, "masks"),
        )
        batches = iter(FilePipeline(ds, batch, h, w, augment=None, shuffle=False,
                                    drop_last=False, device=device))

    report = SegEvaluator(model, cfg.model.num_classes).evaluate(
        batches,
        output_dir=args.output_dir,
        failure_iou_threshold=args.failure_threshold,
        save_plots=args.save_plots,
        worst_k=args.worst_k,
    )
    m = report["metrics"]
    print(json.dumps({k: round(v, 4) for k, v in m.items()}, indent=2))
    print("targets:", report["targets"])
    print(f"report -> {args.output_dir}/evaluation_report.json")
    return report


if __name__ == "__main__":
    main()
