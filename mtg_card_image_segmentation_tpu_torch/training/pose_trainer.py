"""Corner-keypoint (pose) trainer (counterpart of the JAX package's
``training/pose_trainer.py``), on one device or data-parallel over a
``torch.distributed`` process group (``training/trainer.py``); the
validation loss and corner metrics are taken over every rank's batches.

Behavioral spec: train-pose-estimation_custom/train.py:23-352 — AdamW,
ReduceLROnPlateau(factor 0.5, patience 10) on the validation loss, a
checkpoint per ``save_every_epochs`` and the best one on the validation
loss, min-mode early stopping on it, JSON history; exact BatchNorm
recalibration before each validation.

The optimizer is AdamW at a constant rate, optax's
``inject_hyperparams(adamw)(learning_rate=base_lr, weight_decay=wd)``: no
warmup, no schedule and no clip, whatever ``cfg.optimizer`` says about
them. The rate lives in the train state's ``hyperparams`` (optax's
``hyperparams/learning_rate``), so a checkpoint saves it and a resume
restores it; after each validation it is set to ``base_lr * scale`` from
the plateau scheduler. The plateau scheduler itself is not saved: after a
resume its scale starts again at 1.0, as in the JAX trainer.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch import metrics as metrics_lib
from mtg_card_image_segmentation_tpu_torch.config import Config
from mtg_card_image_segmentation_tpu_torch.models import registry
from mtg_card_image_segmentation_tpu_torch.parallel import distributed
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
from mtg_card_image_segmentation_tpu_torch.training.loop import (
    EarlyStopping,
    make_pose_eval_step,
    make_pose_train_step,
    recalibrate_batch_stats,
)
from mtg_card_image_segmentation_tpu_torch.training.optim import OptimizerDef
from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
from mtg_card_image_segmentation_tpu_torch.training.trainer import (
    REFERENCE_TRAIN_IMAGES,
    mesh_of,
    write_history,
)
from mtg_card_image_segmentation_tpu_torch.utils.logging import setup_logger
from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_defaults
from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics: factor, patience,
    min-mode on the validation loss — train-pose-estimation_custom/
    train.py:60-65): the scale falls by ``factor`` after more than
    ``patience`` validations without an improvement of 1e-8, to at least
    ``min_scale``."""

    def __init__(self, factor: float = 0.5, patience: int = 10, min_scale: float = 1e-3):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_scale
        self.best: Optional[float] = None
        self.bad = 0
        self.scale = 1.0

    def step(self, val_loss: float) -> float:
        if self.best is None or val_loss < self.best - 1e-8:
            self.best = val_loss
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad = 0
        return self.scale


class PoseTrainer:
    """``PoseTrainer(cfg)`` trains ``cfg.pose`` (HRNet-W18-small) on the
    CUDA card (``device="cpu"`` on the host). The model starts from Flax's
    default initial values drawn from ``cfg.train.seed``; ``mesh`` as in
    ``SegTrainer``."""

    def __init__(self, cfg: Config, device=None, mesh=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_of(cfg, self.device)
        self.log = setup_logger(log_dir=cfg.train.log_dir)
        self.steps_per_epoch = cfg.train.steps_per_epoch or max(
            1, REFERENCE_TRAIN_IMAGES // cfg.data.batch_size
        )
        model = init_flax_defaults(registry.pose_from_config(cfg.pose), cfg.train.seed)
        self.plateau = ReduceLROnPlateau(patience=10, factor=0.5)
        self._base_lr = cfg.optimizer.learning_rate
        # the rate every update reads; resume updates this dict in place
        hyperparams = {"learning_rate": float(np.float32(self._base_lr))}
        opt_def = OptimizerDef("adamw", cfg.optimizer.weight_decay, cfg.optimizer.momentum,
                               None, lambda count: hyperparams["learning_rate"])
        self.state = create_seg_state(model, opt_def, self.device)
        self.state.hyperparams = hyperparams
        self.train_step = make_pose_train_step(mesh=self.mesh)
        self.eval_step = make_pose_eval_step((cfg.pose.input_height, cfg.pose.input_width))
        self.history: Dict[str, List[float]] = {}
        self.start_epoch = 0
        self.best_metric: Optional[float] = None

    @property
    def learning_rate(self) -> float:
        return self.state.hyperparams["learning_rate"]

    def _set_lr_scale(self, scale: float) -> None:
        # float32, as optax keeps it
        self.state.hyperparams["learning_rate"] = float(np.float32(self._base_lr * scale))

    def resume(self, name: Optional[str] = None) -> None:
        """Restore checkpoint ``name`` (default: the latest) whole: weights,
        statistics, AdamW moments, step and rate, and the run's history."""
        ckpt_dir = self.cfg.train.checkpoint_dir
        name = name or ckpt_lib.latest_checkpoint_name(ckpt_dir)
        if name is None:
            self.log.warning("--resume requested but no checkpoint found")
            return
        self.state, meta = ckpt_lib.load_checkpoint(ckpt_dir, name, self.state)
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        self.best_metric = meta.get("best_metric")
        self.history = meta.get("history", {}) or {}
        self.log.info(f"Resumed from {name} at epoch {self.start_epoch} "
                      f"(lr={self.learning_rate:.3e})")

    def validate(self, val_batches, recal_batches) -> Dict[str, float]:
        """Recalibrate the BatchNorm statistics on ``recal_batches`` (the
        state keeps them), then evaluate ``val_batches`` of (images,
        targets, corners): the corner metrics over all of them and the mean
        loss."""
        recalibrate_batch_stats(self.state, recal_batches)
        losses: List[torch.Tensor] = []
        all_d: List[torch.Tensor] = []
        for images, targets, _ in val_batches:
            stats, distances = self.eval_step(self.state, images, targets)
            losses.append(stats["loss"])
            all_d.append(distances)
        all_d = distributed.all_gather_cat(torch.cat(all_d))
        m = {k: float(v) for k, v in metrics_lib.corner_metrics(all_d).items()}
        m["loss"] = float(np.mean([float(x) for x in
                                   distributed.all_gather_cat(torch.stack(losses))]))
        return m

    def train(self, train_iter, make_val_batches, make_recal_batches) -> Dict[str, List[float]]:
        """``train_iter``: infinite iterator of (images, targets, corners)
        device batches. ``make_val_batches`` / ``make_recal_batches``:
        zero-arg callables returning fresh iterables per epoch."""
        cfg = self.cfg
        es = EarlyStopping(patience=cfg.train.early_stopping_patience, mode="min")
        ckpt_dir = cfg.train.checkpoint_dir
        t_start = time.time()

        for epoch in range(self.start_epoch, cfg.train.num_epochs):
            t_epoch = time.time()
            epoch_losses: List[float] = []
            for step_i in range(self.steps_per_epoch):
                images, targets, _ = next(train_iter)
                self.state, stats = self.train_step(self.state, images, targets)
                if (step_i + 1) % cfg.train.log_every_steps == 0 or (
                    step_i + 1 == self.steps_per_epoch
                ):
                    loss = float(stats["loss"])  # host read only at the log cadence
                    epoch_losses.append(loss)
                    done = step_i + 1
                    dt = time.time() - t_epoch
                    eta = dt / done * (self.steps_per_epoch - done)
                    self.log.info(
                        f"epoch {epoch + 1}/{cfg.train.num_epochs} "
                        f"step {done}/{self.steps_per_epoch} "
                        f"loss={loss:.6f} lr_scale={self.plateau.scale:.3f} "
                        f"{dt / done * 1e3:.1f}ms/step eta={eta:.0f}s"
                    )
            self.history.setdefault("train_loss", []).append(
                float(np.mean(epoch_losses)) if epoch_losses else float("nan")
            )

            val = self.validate(make_val_batches(), make_recal_batches())
            for k, v in val.items():
                self.history.setdefault(f"val_{k}", []).append(v)
            self.log.info(
                f"epoch {epoch + 1} VAL loss={val['loss']:.6f} "
                f"acc3px={val['corner_acc_3px']:.1f}% "
                f"acc6px={val['corner_acc_6px']:.1f}% "
                f"mean_dist={val['mean_corner_distance']:.2f}px"
            )
            self._set_lr_scale(self.plateau.step(val["loss"]))

            if self.best_metric is None or val["loss"] < self.best_metric:
                self.best_metric = val["loss"]
                ckpt_lib.try_save_checkpoint(
                    self.log, ckpt_dir, "best_model", self.state, epoch,
                    self.best_metric, self.history, cfg.to_dict(),
                )
                self.log.info(f"new best val_loss={val['loss']:.6f} -> best_model")
            if (epoch + 1) % cfg.train.save_every_epochs == 0:
                ckpt_lib.try_save_checkpoint(
                    self.log, ckpt_dir, f"checkpoint_epoch_{epoch + 1}", self.state,
                    epoch, self.best_metric, self.history, cfg.to_dict(),
                )
            if es(val["loss"], self.state):
                self.log.info(f"early stopping at epoch {epoch + 1}")
                self.state = es.restore_best(self.state)
                break
            self.log.info(f"epoch {epoch + 1} done in {time.time() - t_epoch:.1f}s")

        ckpt_lib.save_checkpoint(
            ckpt_dir, "final_model", self.state, cfg.train.num_epochs - 1,
            self.best_metric, self.history, cfg.to_dict(),
        )
        write_history(ckpt_dir, self.history)
        self.log.info(
            f"pose training finished in {(time.time() - t_start) / 3600:.2f}h"
        )
        return self.history
