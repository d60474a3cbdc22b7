"""Segmentation trainer, the epoch loop (counterpart of the JAX package's
``training/trainer.py``), on one device or data-parallel over a
``torch.distributed`` process group (one process per GPU, each feeding its
slice of the global batch; ``training/loop.py``).

Per epoch: ``steps_per_epoch`` train steps with progress and ETA at the log
cadence (the only host reads of the loop), then, every
``eval_every_epochs``, validation after an exact BatchNorm recalibration,
the history, best checkpoint and early stopping on the configured metric;
periodic checkpoints every ``save_every_epochs``; at the end the final
checkpoint and ``history.json``. ``resume`` restores a checkpoint's whole
train state and the run's history. Optional ``wandb`` logging. Under a
process group the validation metrics are global, so every rank takes the
same early-stopping decisions, and rank 0 alone writes the checkpoints
and the history. With ``mesh.space`` or ``mesh.model`` above 1 (torchrun
with ``--set mesh.space=2``) the ranks of one data index split the rows of
its images (``parallel/space.py``); the pipelines made under
``space.use(trainer.mesh)`` feed each rank its rows.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch import metrics as metrics_lib
from mtg_card_image_segmentation_tpu_torch.config import Config
from mtg_card_image_segmentation_tpu_torch.models import registry
from mtg_card_image_segmentation_tpu_torch.parallel import distributed, make_mesh, space
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
from mtg_card_image_segmentation_tpu_torch.training.loop import (
    EarlyStopping,
    make_eval_step,
    make_train_step,
    recalibrate_batch_stats,
)
from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
from mtg_card_image_segmentation_tpu_torch.utils.logging import setup_logger
from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_defaults
from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

REFERENCE_TRAIN_IMAGES = 8800  # the reference dataset's scale


def mesh_of(cfg: Config, device):
    """``cfg.mesh`` laid over the process group's ranks, ``device`` each."""
    m = cfg.mesh
    return make_mesh(data=m.data, space=m.space, model=m.model, hosts=m.hosts,
                     devices=[device])


def write_history(ckpt_dir: str, history: dict) -> None:
    """``history.json`` beside the checkpoints, from rank 0 only."""
    if distributed.process_index() == 0:
        with open(os.path.join(ckpt_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=2)


class SegTrainer:
    """``SegTrainer(cfg)`` trains ``cfg.model`` on the CUDA card
    (``device="cpu"`` on the host). The model starts from Flax's default
    initial values drawn from ``cfg.train.seed``. ``mesh``
    (``parallel/mesh.py``) defaults to ``cfg.mesh`` over the process
    group's ranks, one device each."""

    def __init__(self, cfg: Config, device=None, lr_scale: float = 1.0, mesh=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_of(cfg, self.device)
        self.log = setup_logger(log_dir=cfg.train.log_dir)
        self.steps_per_epoch = cfg.train.steps_per_epoch or max(
            1, REFERENCE_TRAIN_IMAGES // cfg.data.batch_size
        )
        model = init_flax_defaults(registry.from_config(cfg.model), cfg.train.seed)
        self.opt_def, self.schedule = create_optimizer(
            cfg.optimizer, cfg.train.num_epochs, self.steps_per_epoch, lr_scale
        )
        self.state = create_seg_state(model, self.opt_def, self.device)
        self.train_step = make_train_step(
            dice_weight=cfg.train.dice_weight,
            ce_weight=cfg.train.ce_weight,
            num_classes=cfg.model.num_classes,
            mesh=self.mesh,
        )
        self.eval_step = make_eval_step(
            dice_weight=cfg.train.dice_weight,
            ce_weight=cfg.train.ce_weight,
            num_classes=cfg.model.num_classes,
            mesh=self.mesh,
        )
        self.history: Dict[str, List[float]] = {}
        self.start_epoch = 0
        self.best_metric: Optional[float] = None
        self._wandb = None
        if cfg.train.wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="mtg-card-segmentation-tpu", config=cfg.to_dict())
            except ImportError:
                self.log.warning("wandb requested but not installed — disabled")

    # ------------------------------------------------------------------
    def resume(self, name: Optional[str] = None) -> None:
        ckpt_dir = self.cfg.train.checkpoint_dir
        name = name or ckpt_lib.latest_checkpoint_name(ckpt_dir)
        if name is None:
            self.log.warning("--resume requested but no checkpoint found")
            return
        self.state, meta = ckpt_lib.load_checkpoint(ckpt_dir, name, self.state)
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        self.best_metric = meta.get("best_metric")
        self.history = meta.get("history", {}) or {}
        self.log.info(f"Resumed from {name} at epoch {self.start_epoch}")

    def _append_history(self, prefix: str, stats: Dict[str, float]) -> None:
        for k, v in stats.items():
            self.history.setdefault(f"{prefix}_{k}", []).append(float(v))

    # ------------------------------------------------------------------
    def validate(self, val_batches: Iterable, recal_batches: Iterable) -> Dict[str, float]:
        """Recalibrate the BatchNorm statistics on ``recal_batches`` (the
        state keeps them), then evaluate ``val_batches`` of (images, masks)
        or (images, masks, valid rows)."""
        with space.use(self.mesh):
            state = recalibrate_batch_stats(self.state, recal_batches)
        acc = metrics_lib.MetricsAccumulator()
        cmacc = metrics_lib.ConfusionAccumulator(self.cfg.model.num_classes)
        for batch in val_batches:
            images, masks = batch[0], batch[1]
            valid = int(batch[2]) if len(batch) > 2 else images.shape[0]
            # a padded tail batch: its fake rows are weighted out of the
            # exact confusion counts
            weights = torch.from_numpy(
                (np.arange(images.shape[0]) < valid).astype(np.int64)).to(images.device)
            stats, cm = self.eval_step(state, images, masks, weights)
            acc.update(stats)
            cmacc.update(cm)
        out = acc.result()
        out.update({f"exact_{k}": v for k, v in cmacc.result().items()})
        return out

    # ------------------------------------------------------------------
    def train(self, train_iter, make_val_batches, make_recal_batches) -> Dict[str, List[float]]:
        """``train_iter``: infinite iterator of (images, masks) device
        batches. ``make_val_batches`` / ``make_recal_batches``: zero-arg
        callables returning fresh iterables per epoch."""
        cfg = self.cfg
        es = EarlyStopping(
            patience=cfg.train.early_stopping_patience,
            mode=cfg.train.early_stopping_mode,
        )
        ckpt_dir = cfg.train.checkpoint_dir
        metric_key = cfg.train.early_stopping_metric
        t_start = time.time()

        for epoch in range(self.start_epoch, cfg.train.num_epochs):
            t_epoch = time.time()
            acc = metrics_lib.MetricsAccumulator()
            last_stats = None
            for step_i in range(self.steps_per_epoch):
                images, masks = next(train_iter)
                self.state, stats = self.train_step(self.state, images, masks)
                last_stats = stats
                if (step_i + 1) % cfg.train.log_every_steps == 0 or (
                    step_i + 1 == self.steps_per_epoch
                ):
                    acc.update(stats)  # host transfer only at log cadence
                    done = step_i + 1
                    dt = time.time() - t_epoch
                    eta = dt / done * (self.steps_per_epoch - done)
                    self.log.info(
                        f"epoch {epoch + 1}/{cfg.train.num_epochs} "
                        f"step {done}/{self.steps_per_epoch} "
                        f"loss={float(stats['loss']):.4f} "
                        f"lr={self.schedule(self.state.step):.2e} "
                        f"{dt / done * 1e3:.1f}ms/step eta={eta:.0f}s"
                    )
            train_stats = acc.result() or metrics_lib.summarize_batch_stats(
                metrics_lib.to_host(last_stats)
            )
            self._append_history("train", train_stats)

            if (epoch + 1) % cfg.train.eval_every_epochs == 0:
                val_stats = self.validate(make_val_batches(), make_recal_batches())
                self._append_history("val", val_stats)
                if self._wandb is not None:
                    self._wandb.log(
                        {f"train/{k}": v for k, v in train_stats.items()}
                        | {f"val/{k}": v for k, v in val_stats.items()},
                        step=epoch + 1,
                    )
                self.log.info(
                    f"epoch {epoch + 1} VAL "
                    f"loss={val_stats['loss']:.4f} "
                    f"mIoU={val_stats['mean_iou']:.4f} "
                    f"iou_card={val_stats.get('iou_card', float('nan')):.4f} "
                    f"pixacc={val_stats['pixel_accuracy']:.4f}"
                )
                metric = val_stats.get(metric_key, val_stats["mean_iou"])
                improved = self.best_metric is None or (
                    metric > self.best_metric
                    if cfg.train.early_stopping_mode == "max"
                    else metric < self.best_metric
                )
                if improved:
                    self.best_metric = metric
                    ckpt_lib.try_save_checkpoint(
                        self.log, ckpt_dir, "best_model", self.state, epoch,
                        self.best_metric, self.history, cfg.to_dict(),
                    )
                    self.log.info(f"new best {metric_key}={metric:.4f} -> best_model")
                if es(metric, self.state):
                    self.log.info(
                        f"early stopping at epoch {epoch + 1} "
                        f"(no {metric_key} improvement for {es.patience} evals)"
                    )
                    self.state = es.restore_best(self.state)
                    break

            if (epoch + 1) % cfg.train.save_every_epochs == 0:
                ckpt_lib.try_save_checkpoint(
                    self.log, ckpt_dir, f"checkpoint_epoch_{epoch + 1}", self.state,
                    epoch, self.best_metric, self.history, cfg.to_dict(),
                )
            self.log.info(f"epoch {epoch + 1} done in {time.time() - t_epoch:.1f}s")

        ckpt_lib.save_checkpoint(
            ckpt_dir, "final_model", self.state,
            cfg.train.num_epochs - 1, self.best_metric, self.history, cfg.to_dict(),
        )
        write_history(ckpt_dir, self.history)
        self.log.info(
            f"training finished in {(time.time() - t_start) / 3600:.2f}h; "
            f"best {cfg.train.early_stopping_metric}={self.best_metric}"
        )
        return self.history
