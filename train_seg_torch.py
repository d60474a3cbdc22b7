#!/usr/bin/env python
"""Segmentation training CLI of the PyTorch port (counterpart of
``train_seg.py``; reference entry point: python train/train.py). Runs on the
CUDA card; ``--device cpu`` runs on the host.

Examples:
  # train on the synthetic stream rendered and augmented on the card
  python train_seg_torch.py --source synthetic --set train.num_epochs=5

  # train on a disk dataset with the reference layout
  python train_seg_torch.py --source files --set data.dataset_root=./dataset

  # resume from the latest checkpoint (or --resume <name>)
  python train_seg_torch.py --resume
  # and write <train.log_dir>/training_history.png (needs matplotlib)
  python train_seg_torch.py --plot

  # data-parallel over N cards of one host, one process per card
  # (data.batch_size is the global batch; nccl on the card, gloo with
  # --device cpu)
  torchrun --nproc_per_node=N train_seg_torch.py --set data.batch_size=64
  # spatially sharded: the rows of every image split over 2 ranks
  # (torchrun --nproc_per_node=2 ... --device cpu on the host: gloo)
  torchrun --nproc_per_node=2 train_seg_torch.py --set mesh.space=2
"""

from __future__ import annotations

import argparse
import itertools
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=str, default=None, help="JSON config file")
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v", help="config overrides")
    parser.add_argument("--source", choices=["synthetic", "files"], default="synthetic")
    parser.add_argument("--resume", nargs="?", const="__latest__", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--plot", action="store_true",
                        help="write the history plot (needs matplotlib)")
    args = parser.parse_args(argv)

    import torch

    from mtg_card_image_segmentation_tpu_torch.config import Config, default_config
    from mtg_card_image_segmentation_tpu_torch.data.pipeline import rank_seed
    from mtg_card_image_segmentation_tpu_torch.data.preprocess import normalize_only
    from mtg_card_image_segmentation_tpu_torch.parallel import distributed, space
    from mtg_card_image_segmentation_tpu_torch.training.trainer import SegTrainer
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    # torchrun: join the process group, one rank per card; a no-op for a
    # lone process
    distributed.initialize(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda" and distributed.is_active():
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = Config.from_json(args.config) if args.config else default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)

    trainer = SegTrainer(cfg, device=device)
    trainer.log.info(f"device {device}"
                     + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    # under a mesh with space or model axes the pipelines feed each rank
    # its rows of its data shard (parallel/space.py)
    with space.use(trainer.mesh):
        h, w = cfg.model.input_height, cfg.model.input_width
        batch = cfg.data.batch_size

        if args.source == "synthetic":
            from mtg_card_image_segmentation_tpu_torch.data.pipeline import SyntheticPipeline
            from mtg_card_image_segmentation_tpu_torch.data.synthetic import (
                load_asset_bank,
                synthetic_batch,
            )

            assets = None
            if cfg.data.texture_dir or cfg.data.background_dir or cfg.data.hdri_dir:
                assets = load_asset_bank(cfg.data.texture_dir or None, cfg.data.background_dir or None,
                                         bg_hw=(h, w), hdri_dir=cfg.data.hdri_dir or None,
                                         device=device)
                trainer.log.info(f"asset bank: {assets.textures.shape[0]} textures, "
                                 f"{assets.backgrounds.shape[0]} backgrounds, "
                                 f"{assets.hdris.shape[0]} HDRIs")

            train_iter = iter(SyntheticPipeline(batch, h, w, augment=cfg.data.augment,
                                                seed=cfg.train.seed, assets=assets,
                                                real_prob=cfg.data.real_asset_prob, device=device))

            val_batch = distributed.local_batch_size(batch)

            def _val_batch(seed: int):
                # made afresh from its seed, so every epoch sees the same images;
                # with a bank, validation covers the real-asset domain too; each
                # rank renders its share from its own seed
                gen = torch.Generator(device=device).manual_seed(rank_seed(seed))
                b = synthetic_batch(gen, val_batch, h, w, 0.09, assets, cfg.data.real_asset_prob)
                return space.shard_rows(normalize_only(b.image)), space.shard_rows(b.mask)

            def make_val_batches(n: int = 8, seed: int = 10_000):
                return [_val_batch(seed + i) for i in range(n)]

            def make_recal_batches(n: int = 6, seed: int = 20_000):
                return [_val_batch(seed + i)[0] for i in range(n)]

        else:
            from mtg_card_image_segmentation_tpu_torch.data.dataset import CardSegmentationDataset
            from mtg_card_image_segmentation_tpu_torch.data.pipeline import FilePipeline

            root = cfg.data.dataset_root

            def split(name):
                return CardSegmentationDataset(os.path.join(root, name, "images"),
                                               os.path.join(root, name, "masks"))

            train_ds, test_ds = split(cfg.data.train_split), split(cfg.data.test_split)
            train_pipe = FilePipeline(train_ds, batch, h, w, augment=cfg.data.augment, shuffle=True,
                                      seed=cfg.train.seed, prefetch=cfg.data.prefetch, device=device)
            if cfg.train.steps_per_epoch is None:
                # as in train_seg.py: the epoch follows the dataset, the schedule
                # keeps the length SegTrainer derived from the reference's size
                trainer.steps_per_epoch = train_pipe.steps_per_epoch

            def forever(pipe):
                while True:
                    for imgs, msks, _valid in pipe:
                        yield imgs, msks  # drop_last: always full batches

            train_iter = forever(train_pipe)

            def make_val_batches():
                # the test split unshuffled, its tail batch padded; the trainer
                # weights the padding out by ``valid``. Over several ranks the
                # tail is dropped (the JAX CLI's rule: per-rank padding is not
                # accounted)
                return iter(FilePipeline(test_ds, batch, h, w, augment=None, shuffle=False,
                                         drop_last=distributed.process_count() > 1,
                                         device=device))

            def make_recal_batches(n: int = 6):
                pipe = FilePipeline(train_ds, batch, h, w, augment=None, shuffle=True,
                                    device=device)
                it = iter(pipe)
                try:
                    return [imgs for imgs, *_ in itertools.islice(it, n)]
                finally:
                    it.close()

        if args.resume is not None:
            trainer.resume(None if args.resume == "__latest__" else args.resume)

        history = trainer.train(train_iter, make_val_batches, make_recal_batches)
    if args.plot and distributed.process_index() == 0:
        from mtg_card_image_segmentation_tpu_torch.utils.plots import plot_training_history

        out = plot_training_history(
            history, os.path.join(cfg.train.log_dir, "training_history.png"))
        print(f"history plot -> {out}")
    return history


if __name__ == "__main__":
    main()
