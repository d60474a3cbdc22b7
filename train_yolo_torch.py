#!/usr/bin/env python
"""YOLO12n-pose corner training CLI of the PyTorch port (counterpart of
``train_yolo.py``; reference entry point: python
train-pose-estimation_yolo12n/train.py, which delegates to ultralytics
model.train(); here the loss and assigner are native,
``training/yolo_loss.py``). Runs on the CUDA card; ``--device cpu`` runs on
the host.

The model starts from Flax's default initial values drawn from
``train.seed``, the head's 1 % priors included. The optimizer and its
schedule are ``cfg.optimizer``'s (``create_optimizer``: AdamW, cosine with
warmup by default) over ``train.steps_per_epoch`` or 8800 // batch steps per
epoch. Each step renders and augments a batch on the device
(``synthetic_augmented_batch`` without the elastic/grid displacement, cards
kept in frame, corners re-canonicalized after the flip) from one generator
seeded with ``train.seed`` + the first epoch of the run. Each epoch ends with
the top-1 corner distances over 4 clean rendered batches from the fixed
seeds 10,000 + i; the lowest mean corner distance is ``best_model``. Also
``checkpoint_epoch_N`` every ``train.save_every_epochs``, ``final_model``
and ``history.json``; ``--resume`` continues from the latest checkpoint (or
the one named) with its epoch, best and history.

Examples:
  python train_yolo_torch.py --set train.num_epochs=5 data.batch_size=16
  python train_yolo_torch.py --resume                  # or --resume <name>
  python train_yolo_torch.py --device cpu --imgsz 64 --set data.batch_size=2 \\
      train.num_epochs=1 train.steps_per_epoch=2
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

EVAL_SEED = 10_000
EVAL_BATCHES = 4


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=str, default=None, help="JSON config file")
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v", help="config overrides")
    parser.add_argument("--imgsz", type=int, default=640, help="square input size")
    parser.add_argument("--resume", nargs="?", const="__latest__", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch import metrics as metrics_lib
    from mtg_card_image_segmentation_tpu_torch.config import Config, default_config
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import (
        synthetic_augmented_batch,
        synthetic_batch,
    )
    from mtg_card_image_segmentation_tpu_torch.models.registry import create_model
    from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import top1_detection
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.training.yolo_loss import make_yolo_train_step
    from mtg_card_image_segmentation_tpu_torch.utils.logging import setup_logger
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_defaults
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = Config.from_json(args.config) if args.config else default_config()
    cfg = cfg.override({"train": {"early_stopping_metric": "mean_corner_distance",
                                  "early_stopping_mode": "min"}})
    if args.set:
        cfg = cfg.with_cli(args.set)
    log = setup_logger(log_dir=cfg.train.log_dir)
    log.info(f"device {device}"
             + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    size = args.imgsz
    batch = cfg.data.batch_size
    steps = cfg.train.steps_per_epoch or max(1, 8800 // batch)

    model = init_flax_defaults(create_model("yolo12n_pose"), cfg.train.seed)
    opt_def, _ = create_optimizer(cfg.optimizer, cfg.train.num_epochs, steps)
    state = create_seg_state(model, opt_def, device)
    step_fn = make_yolo_train_step()
    aug = cfg.data.augment

    def make_batch(gen):
        # fused render + augment; the keypoint path has no elastic/grid
        # displacement, so the corners stay exact
        s = synthetic_augmented_batch(gen, batch, size, size, 0.0, aug,
                                      with_displacement=False, keep_in_frame=True)
        return s.image, s.corners

    @torch.no_grad()
    def eval_distances():
        """(EVAL_BATCHES * batch, 4) top-1 corner distances in pixels on
        clean renders from fixed seeds."""
        model = state.model.eval()
        dists = []
        for i in range(EVAL_BATCHES):
            gen = torch.Generator(device=device).manual_seed(EVAL_SEED + i)
            s = synthetic_batch(gen, batch, size, size, 0.0, keep_in_frame=True)
            _, _, kpts = top1_detection(*model(s.image))
            dists.append(((kpts[..., :2] - s.corners) ** 2).sum(-1).sqrt())
        return torch.cat(dists)

    start_epoch = 0
    best = None
    history: dict = {}
    ckpt_dir = cfg.train.checkpoint_dir
    if args.resume is not None:
        name = None if args.resume == "__latest__" else args.resume
        name = name or ckpt_lib.latest_checkpoint_name(ckpt_dir)
        if name:
            state, meta = ckpt_lib.load_checkpoint(ckpt_dir, name, state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            best = meta.get("best_metric")
            history = meta.get("history", {}) or {}
            log.info(f"Resumed from {name} at epoch {start_epoch}")
        else:
            log.warning("--resume requested but no checkpoint found")

    gen = torch.Generator(device=device).manual_seed(cfg.train.seed + start_epoch)
    for epoch in range(start_epoch, cfg.train.num_epochs):
        t0 = time.time()
        epoch_losses = []
        for i in range(steps):
            images, corners = make_batch(gen)
            state, parts = step_fn(state, images, corners)
            if (i + 1) % cfg.train.log_every_steps == 0 or i + 1 == steps:
                # host reads only at the log cadence
                host = {k: float(v) for k, v in parts.items()}
                epoch_losses.append(host["loss"])
                log.info(
                    f"epoch {epoch + 1}/{cfg.train.num_epochs} step {i + 1}/{steps} "
                    f"loss={host['loss']:.4f} box={host['box_loss']:.3f} "
                    f"kpt={host['kpt_loss']:.3f} cls={host['cls_loss']:.3f} "
                    f"{(time.time() - t0) / (i + 1) * 1e3:.1f}ms/step"
                )
        m = {k: float(v) for k, v in metrics_lib.corner_metrics(eval_distances()).items()}
        history.setdefault("train_loss", []).append(
            float(np.mean(epoch_losses)) if epoch_losses else float("nan"))
        for k, v in m.items():
            history.setdefault(f"val_{k}", []).append(v)
        log.info(
            f"epoch {epoch + 1} VAL mean_dist={m['mean_corner_distance']:.1f}px "
            f"acc5={m['corner_acc_5px']:.1f}% acc10={m['corner_acc_10px']:.1f}% "
            f"acc20={m['corner_acc_20px']:.1f}% ({time.time() - t0:.0f}s)"
        )
        if best is None or m["mean_corner_distance"] < best:
            best = m["mean_corner_distance"]
            ckpt_lib.try_save_checkpoint(log, ckpt_dir, "best_model", state, epoch, best,
                                         history, cfg.to_dict())
        if (epoch + 1) % cfg.train.save_every_epochs == 0:
            ckpt_lib.try_save_checkpoint(log, ckpt_dir, f"checkpoint_epoch_{epoch + 1}",
                                         state, epoch, best, history, cfg.to_dict())
    ckpt_lib.save_checkpoint(ckpt_dir, "final_model", state, cfg.train.num_epochs - 1, best,
                             history, cfg.to_dict())
    with open(os.path.join(ckpt_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=2)
    log.info(f"done; best mean corner distance {best:.1f}px")
    return history


if __name__ == "__main__":
    main()
