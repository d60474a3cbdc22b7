#!/usr/bin/env python
"""Corner-keypoint (HRNet heatmap) training CLI of the PyTorch port
(counterpart of ``train_pose.py``; reference entry point: python
train-pose-estimation_custom/train.py). Runs on the CUDA card;
``--device cpu`` runs on the host.

The training stream is rendered and augmented on the device from
``train.seed``; validation draws six clean (unaugmented) batches per epoch,
and the BatchNorm recalibration four, from one stream seeded with 99,999
that goes on from epoch to epoch, as the JAX CLI's does.

Examples:
  python train_pose_torch.py --set train.num_epochs=5
  python train_pose_torch.py --resume                  # or --resume <name>
  python train_pose_torch.py --device cpu --set pose.input_height=64 \\
      pose.input_width=96 pose.heatmap_height=16 pose.heatmap_width=24 \\
      data.batch_size=2 train.num_epochs=1 train.steps_per_epoch=2
  torchrun --nproc_per_node=N train_pose_torch.py   # data-parallel, one rank per card
"""

from __future__ import annotations

import argparse
import itertools
from typing import List, Optional

VAL_SEED = 99_999


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=str, default=None, help="JSON config file")
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v", help="config overrides")
    parser.add_argument("--resume", nargs="?", const="__latest__", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mtg_card_image_segmentation_tpu_torch.config import Config, pose_default_config
    from mtg_card_image_segmentation_tpu_torch.data.pipeline import PoseSyntheticPipeline
    from mtg_card_image_segmentation_tpu_torch.parallel import distributed
    from mtg_card_image_segmentation_tpu_torch.training.pose_trainer import PoseTrainer
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    # torchrun: join the process group, one rank per card; a no-op for a
    # lone process
    distributed.initialize(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda" and distributed.is_active():
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = Config.from_json(args.config) if args.config else pose_default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)

    trainer = PoseTrainer(cfg, device=device)
    trainer.log.info(f"device {device}"
                     + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    p = cfg.pose
    shape = (cfg.data.batch_size, p.input_height, p.input_width, p.heatmap_height,
             p.heatmap_width)
    train_iter = iter(PoseSyntheticPipeline(*shape, sigma=p.gaussian_sigma,
                                            augment=cfg.data.augment, seed=cfg.train.seed,
                                            device=device))
    # validation: a clean (unaugmented) stream from a fixed seed
    val_pipe = PoseSyntheticPipeline(*shape, sigma=p.gaussian_sigma, augment=None,
                                     seed=VAL_SEED, device=device)

    def make_val_batches(n: int = 6):
        return list(itertools.islice(iter(val_pipe), n))

    def make_recal_batches(n: int = 4):
        return [b[0] for b in itertools.islice(iter(val_pipe), n)]

    if args.resume is not None:
        trainer.resume(None if args.resume == "__latest__" else args.resume)

    return trainer.train(train_iter, make_val_batches, make_recal_batches)


if __name__ == "__main__":
    main()
