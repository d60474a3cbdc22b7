#!/usr/bin/env python
"""Pose training cost split into data generation and the train step
(counterpart of ``tools/profile_pose_step.py``), on the CUDA card.

    python tools/profile_pose_step_torch.py                  (b24, b48, b96)
    python tools/profile_pose_step_torch.py --batches 24 --steps 5
    python tools/profile_pose_step_torch.py --device cpu --batches 2 --steps 1 \\
        --size 64 96 --heatmap 16 24

For each batch: ``PoseSyntheticPipeline`` (the pose config's augmentation,
seed 0) timed per batch, then the HRNet pose train step of
``training/loop.py::make_pose_train_step`` (the pose config's model,
seeded Flax-default weights, AdamW at 1e-3 with weight decay 1e-4, as the
JAX tool's ``optax.adamw(1e-3)``) timed per step on one batch of that
pipeline, and the combined rate ``batch / (generate + step)``. Each time is
the mean over ``--steps`` calls after two warm-up calls, on the host clock
with a synchronize of the device before each reading. Sizes default to the
pose config's (480x640, 120x160 heatmaps).

Prints one line per batch (as the JAX tool) and a final JSON line with
every number, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mean_ms(fn, steps: int, device, warmup: int = 2) -> float:
    """Mean wall ms of ``fn`` over ``steps`` calls after ``warmup``, the
    device synchronized before each clock reading."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / steps


def run(batches=(24, 48, 96), steps: int = 10, size=None, heatmap=None,
        device: str = "cuda") -> dict:
    """Time generation and the train step at each batch; returns the record
    the tool prints."""
    import torch

    from mtg_card_image_segmentation_tpu_torch.config import pose_default_config
    from mtg_card_image_segmentation_tpu_torch.data.pipeline import PoseSyntheticPipeline
    from mtg_card_image_segmentation_tpu_torch.models import registry
    from mtg_card_image_segmentation_tpu_torch.training.loop import make_pose_train_step
    from mtg_card_image_segmentation_tpu_torch.training.optim import OptimizerDef
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_defaults
    from mtg_card_image_segmentation_tpu_torch.utils.platform import (
        nvidia_smi_name_power,
        resolve_device,
    )

    dev = resolve_device(device)
    cfg = pose_default_config()
    h, w = size or (cfg.pose.input_height, cfg.pose.input_width)
    hh, hw = heatmap or (cfg.pose.heatmap_height, cfg.pose.heatmap_width)
    cfg = cfg.override({"pose": {"input_height": h, "input_width": w,
                                 "heatmap_height": hh, "heatmap_width": hw}})
    rows = []
    for batch in batches:
        pipe = PoseSyntheticPipeline(batch, h, w, hh, hw, sigma=2.0,
                                     augment=cfg.data.augment, seed=0, device=dev)
        gen_ms = mean_ms(lambda: pipe.next_batch()[0], steps, dev)

        model = init_flax_defaults(registry.pose_from_config(cfg.pose), 0)
        state = create_seg_state(model, OptimizerDef("adamw", 1e-4, 0.9, None, lambda c: 1e-3),
                                 dev)
        step = make_pose_train_step()
        images, targets, _ = pipe.next_batch()
        losses = []

        def train():
            _, stats = step(state, images, targets)
            losses.append(stats["loss"])

        step_ms = mean_ms(train, steps, dev)
        loss = float(losses[-1])
        rows.append({"batch": batch, "datagen_ms": gen_ms, "train_step_ms": step_ms,
                     "img_per_s_combined": batch * 1e3 / (gen_ms + step_ms),
                     "loss": loss, "loss_finite": math.isfinite(loss)})
        del state, model, pipe
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    cuda = dev.type == "cuda"
    return {"tool": "profile_pose_step", "size": [h, w], "heatmap": [hh, hw], "steps": steps,
            "rows": rows, "device": torch.cuda.get_device_name(dev) if cuda else "host CPU",
            "nvidia_smi": nvidia_smi_name_power() if cuda else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", type=int, nargs="+", default=[24, 48, 96])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--size", type=int, nargs=2, default=None, metavar=("H", "W"))
    ap.add_argument("--heatmap", type=int, nargs=2, default=None, metavar=("H", "W"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rec = run(tuple(args.batches), args.steps, args.size, args.heatmap, args.device)
    for r in rec["rows"]:
        print(f"batch {r['batch']:3d}: datagen {r['datagen_ms']:7.1f} ms  "
              f"train_step {r['train_step_ms']:7.1f} ms  "
              f"-> {r['img_per_s_combined']:7.1f} img/s combined")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
