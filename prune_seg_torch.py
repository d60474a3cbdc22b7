#!/usr/bin/env python
"""Pruning CLI of the PyTorch port (counterpart of ``prune_seg.py``;
reference: python train/prune.py): load checkpoint -> evaluate -> prune
(global magnitude, structured channels or expansion channels) -> fine-tune
at 0.1x lr with sparsity preserved -> BN recalibration -> evaluate ->
report. Runs on the CUDA card; ``--device cpu`` runs on the host.

  python prune_seg_torch.py --checkpoint ckpts/best_model --amount 0.3
  python prune_seg_torch.py --checkpoint ckpts/best_model --structured --fine-tune-epochs 2

Writes ``<output-dir>/pruned_model`` (a train-state checkpoint) and
``<output-dir>/pruning_report.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--amount", type=float, default=0.3)
    parser.add_argument(
        "--method", choices=["magnitude", "structured", "expansion"],
        default=None,
        help="magnitude: global unstructured L1 (train/prune.py:68-72); "
        "structured: per-conv output channels (:76-93); expansion: "
        "inverted-residual expansion channels zeroed *removably* — "
        "export_seg_torch.py --slim then physically deletes them",
    )
    parser.add_argument("--structured", action="store_true",
                        help="alias for --method structured")
    parser.add_argument("--fine-tune-epochs", type=int, default=0)
    parser.add_argument("--fine-tune-steps", type=int, default=50, help="steps/epoch")
    parser.add_argument("--eval-batches", type=int, default=5)
    parser.add_argument("--output-dir", default="pruned")
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mtg_card_image_segmentation_tpu_torch import metrics as metrics_lib
    from mtg_card_image_segmentation_tpu_torch.compression import (
        magnitude_prune,
        masked_optimizer,
        sparsity_report,
        structured_channel_prune,
    )
    from mtg_card_image_segmentation_tpu_torch.compression.slim import expansion_channel_prune
    from mtg_card_image_segmentation_tpu_torch.config import default_config
    from mtg_card_image_segmentation_tpu_torch.data.pipeline import SyntheticPipeline
    from mtg_card_image_segmentation_tpu_torch.data.preprocess import normalize_only
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch
    from mtg_card_image_segmentation_tpu_torch.models import registry
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.training.loop import (
        make_eval_step,
        make_train_step,
        recalibrate_batch_stats,
    )
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.training.state import SegTrainState
    from mtg_card_image_segmentation_tpu_torch.utils.params import flax_to_state_dict
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg = default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)
    h, w = cfg.model.input_height, cfg.model.input_width
    batch = cfg.data.batch_size

    ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
    params, batch_stats, _ = ckpt_lib.load_params(ckpt_dir or ".", name)

    def make_eval_batch(seed: int):
        b = synthetic_batch(torch.Generator(device=device).manual_seed(seed), batch, h, w)
        return normalize_only(b.image), b.mask

    eval_step = make_eval_step(dice_weight=cfg.train.dice_weight,
                               ce_weight=cfg.train.ce_weight,
                               num_classes=cfg.model.num_classes)

    def evaluate(state):
        cm = metrics_lib.ConfusionAccumulator(cfg.model.num_classes)
        for i in range(args.eval_batches):
            images, masks = make_eval_batch(5_000_000 + i)
            _, c = eval_step(state, images, masks)
            cm.update(c)
        return cm.result()

    def model_of(p, s):
        model = registry.from_config(cfg.model)
        model.load_state_dict(flax_to_state_dict(p, s), strict=True)
        return model.to(device)

    # the optimizer of the saved train state (a fresh one, as the JAX CLI's)
    opt_def, _ = create_optimizer(cfg.optimizer, 1, 1)
    state = SegTrainState(model_of(params, batch_stats), opt_def)
    before = evaluate(state)
    print(f"before pruning: iou_card={before['iou_card']:.4f}")

    # pruning works on the Flax layout (HWIO kernels): structured pruning
    # removes the last axis, the output channels
    method = args.method or ("structured" if args.structured else "magnitude")
    prune_fn = {"magnitude": magnitude_prune, "structured": structured_channel_prune,
                "expansion": expansion_channel_prune}[method]
    pruned_params, masks = prune_fn(params, args.amount)
    sp = sparsity_report(pruned_params)
    print(
        f"pruned ({method}, "
        f"amount={args.amount}): global sparsity {sp['global_sparsity']:.1%}, "
        f"compression {sp['compression_ratio']:.2f}x"
    )

    if args.fine_tune_epochs > 0:
        # fine-tune at 0.1x lr with masked updates (train/prune.py:172-239)
        ft_def, _ = create_optimizer(cfg.optimizer, args.fine_tune_epochs,
                                     args.fine_tune_steps, lr_scale=0.1)
        model = model_of(pruned_params, batch_stats)
        state = SegTrainState(model, masked_optimizer(ft_def, masks, model))
        step_fn = make_train_step(dice_weight=cfg.train.dice_weight,
                                  ce_weight=cfg.train.ce_weight,
                                  num_classes=cfg.model.num_classes)
        pipe = iter(SyntheticPipeline(batch, h, w, augment=cfg.data.augment, seed=7,
                                      device=device))
        total = args.fine_tune_epochs * args.fine_tune_steps
        t_first = None
        for i in range(total):
            images, m = next(pipe)
            state, stats = step_fn(state, images, m)
            if i == 0:
                # the first step pays the process's warm-up; time the rest
                float(stats["loss"])
                t_first = time.perf_counter()
            if (i + 1) % 25 == 0:
                print(f"fine-tune {i + 1}/{total} loss={float(stats['loss']):.4f}")
        if total > 1:
            float(stats["loss"])  # waits for the last step
            ms = (time.perf_counter() - t_first) * 1e3 / (total - 1)
            print(f"fine-tune steps 2-{total}: {ms:.1f}ms/step")
        sp_after = sparsity_report(state.variables()["params"])
        print(f"sparsity after fine-tune: {sp_after['global_sparsity']:.1%}")
    else:
        state = SegTrainState(model_of(pruned_params, batch_stats), opt_def)

    recal = [make_eval_batch(6_000_000 + i)[0] for i in range(4)]
    state = recalibrate_batch_stats(state, recal)
    after = evaluate(state)
    print(f"after pruning:  iou_card={after['iou_card']:.4f}")

    os.makedirs(args.output_dir, exist_ok=True)
    ckpt_lib.save_checkpoint(
        args.output_dir, "pruned_model", state, 0, after["iou_card"],
        config=cfg.to_dict(),
    )
    report = {
        "method": method,
        "amount": args.amount,
        "before": before,
        "after": after,
        "iou_card_delta": after["iou_card"] - before["iou_card"],
        "sparsity": {k: v for k, v in sp.items() if k != "layers"},
    }
    with open(os.path.join(args.output_dir, "pruning_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"pruned checkpoint + report -> {args.output_dir}/")
    return report


if __name__ == "__main__":
    main()
