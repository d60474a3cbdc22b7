"""Train/eval steps, exact BatchNorm recalibration and early stopping
(counterpart of the JAX package's ``training/loop.py``).

- A train step is eager PyTorch: forward (the modules' own bf16 casts),
  loss, backward, optimizer update; the BatchNorm running statistics move
  during the forward. Its per-batch metric stats stay on the device, so the
  host reads nothing back until the trainer logs.
- A segmentation eval step returns the per-batch stats and the exact
  confusion counts, with optional per-image 0/1 weights for padded rows.
- The pose steps train on the MSE of the corner heatmaps; the pose eval
  step also decodes the predicted and the target heatmaps and returns the
  per-corner pixel distances.
- Under a ``torch.distributed`` process group (``parallel/distributed.py``)
  the steps are data-parallel, as the JAX steps are over a data-sharded
  mesh: each rank feeds its slice of the global batch, the train steps
  call the model through ``DistributedDataParallel``
  (``SegTrainState.train_module``), and the BatchNorm statistics, the
  segmentation loss, the stats and the confusion counts are the global
  batch's; the pose step's reported loss is the mean over ranks. ``mesh``
  (``parallel/mesh.py``) must have been laid for the group's ranks.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional

import torch

from mtg_card_image_segmentation_tpu_torch import losses as losses_lib
from mtg_card_image_segmentation_tpu_torch import metrics as metrics_lib
from mtg_card_image_segmentation_tpu_torch.models.layers import FlaxBatchNorm2d
from mtg_card_image_segmentation_tpu_torch.parallel import distributed
from mtg_card_image_segmentation_tpu_torch.training.state import SegTrainState


def check_mesh(mesh) -> None:
    """A ``mesh`` given to a step must have been laid for the process
    group's ranks (the JAX steps take their sharding from it; here the
    process group does the work, and the mesh must agree with it)."""
    if mesh is not None and mesh.ranks != distributed.process_count():
        raise ValueError(f"the mesh was laid for {mesh.ranks} ranks, the process group "
                         f"has {distributed.process_count()}")


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """A detached scalar's mean over the ranks (itself on one process)."""
    return distributed.all_reduce_sum(x.detach()) / distributed.process_count()


def make_train_step(dice_weight: float = 0.5, ce_weight: float = 0.5,
                    num_classes: int = 2, mesh=None):
    """``step(state, images, masks) -> (state, stats)``: one update of
    ``state`` in place from NHWC float ``images`` and (B, H, W) int
    ``masks``. ``stats`` is a dict of device tensors for
    :class:`metrics.MetricsAccumulator`. The gradients stay in ``.grad``
    until the next step."""
    check_mesh(mesh)

    def train_step(state: SegTrainState, images: torch.Tensor, masks: torch.Tensor):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.train_module()(images)
        loss = losses_lib.combined_loss(logits, masks, dice_weight=dice_weight,
                                        ce_weight=ce_weight)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            stats = metrics_lib.segmentation_batch_stats(loss, logits.detach(), masks,
                                                         num_classes)
        return state, stats

    return train_step


def make_eval_step(dice_weight: float = 0.5, ce_weight: float = 0.5,
                   num_classes: int = 2, mesh=None):
    """``step(state, images, masks, weights=None) -> (stats, confusion)``
    in eval mode (running statistics). ``weights`` (per-image 0/1) keep
    padded rows of the last eval batch out of the exact confusion counts;
    the smoothed per-batch stats stay whole-batch."""
    check_mesh(mesh)

    @torch.no_grad()
    def eval_step(state: SegTrainState, images: torch.Tensor, masks: torch.Tensor,
                  weights: Optional[torch.Tensor] = None):
        logits = state.model.eval()(images)
        loss = losses_lib.combined_loss(logits, masks, dice_weight=dice_weight,
                                        ce_weight=ce_weight)
        stats = metrics_lib.segmentation_batch_stats(loss, logits, masks, num_classes)
        cm = distributed.all_reduce_sum(metrics_lib.confusion_matrix(
            torch.argmax(logits, dim=-1), masks, num_classes, weights))
        return stats, cm

    return eval_step


def make_pose_train_step(mesh=None):
    """``step(state, images, targets) -> (state, stats)``: one update of
    ``state`` in place on the MSE between the model's (B, hm_h, hm_w, K)
    heatmaps and ``targets`` (CornerLoss semantics,
    train-pose-estimation_custom/metrics.py:105-136). ``stats`` holds the
    loss and a count of 1, on the device.

    The last stage's fusion outputs of the three finer branches feed
    nothing (the head reads the coarsest), so their convs get no gradient.
    optax still updates them with a zero gradient (AdamW's weight decay
    moves them); so does this step, which gives them zero gradients where
    autograd left none."""
    check_mesh(mesh)

    def train_step(state: SegTrainState, images: torch.Tensor, targets: torch.Tensor):
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=False)
        net = state.train_module(find_unused_parameters=True)
        loss = losses_lib.heatmap_mse_loss(net(images), targets)
        loss.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.apply_gradients()
        stats = {"loss": mean_over_ranks(loss).float(),
                 "count": torch.ones((), device=loss.device)}
        return state, stats

    return train_step


def float64_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A float64 copy of ``model``, its compute dtypes (``self.dtype``)
    made float64; ``model`` itself is left as it was. Call it inside
    :func:`float64_casts`."""
    import copy

    ref = copy.deepcopy(model).double()
    for m in ref.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return ref


@contextmanager
def float64_casts():
    """``Tensor.float`` made ``Tensor.double`` inside the block: the port's
    modules cast to float32 where the reference does, and a float64 pass
    keeps float64 through those casts."""
    cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = cast


def grads_float64(model: torch.nn.Module, loss_of, *inputs: torch.Tensor):
    """A train step's loss and gradients in float64, the reference that the
    float32 step's gradients are held to: ``loss_of(copy, *inputs)`` on a
    float64 copy of ``model`` in train mode, with its float32 casts
    (``Tensor.float``) made float64 for the call and ``inputs`` made
    float64 where they are floating point; ``model`` itself is left as it
    was. Returns (loss, {parameter name: gradient}, the float64 copy),
    zeros where a parameter feeds nothing, as the steps give them; the
    copy's BatchNorm running statistics have moved as the step's do, in
    float64."""
    ref = float64_copy(model).train()
    with float64_casts():
        loss = loss_of(ref, *(x.double() if x.is_floating_point() else x for x in inputs))
        loss.backward()
    return float(loss.detach()), {n: torch.zeros_like(p) if p.grad is None else p.grad
                                  for n, p in ref.named_parameters()}, ref


def pose_grads_float64(model: torch.nn.Module, images: torch.Tensor,
                       targets: torch.Tensor):
    """The pose train step's loss and gradients in float64
    (:func:`grads_float64` of the heatmap MSE)."""
    return grads_float64(model, lambda m, x, t: losses_lib.heatmap_mse_loss(m(x), t),
                         images, targets)[:2]


def make_pose_eval_step(image_hw: tuple[int, int]):
    """``step(state, images, targets) -> (stats, distances)`` in eval mode:
    the loss, and the (B, K) pixel distances between the sub-pixel decodes
    of the predicted and the target heatmaps, scaled by ``image_hw``
    (CornerMetrics, metrics.py:29-73, with the decode the evaluator and the
    server use)."""
    from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm_lib

    @torch.no_grad()
    def eval_step(state: SegTrainState, images: torch.Tensor, targets: torch.Tensor):
        heatmaps = state.model.eval()(images)
        loss = losses_lib.heatmap_mse_loss(heatmaps, targets)
        pred_xy, _ = hm_lib.decode_argmax_subpixel(heatmaps)
        tgt_xy, _ = hm_lib.decode_argmax_subpixel(targets)
        distances = metrics_lib.corner_distances(pred_xy, tgt_xy, image_hw)
        return {"loss": loss.float(), "count": torch.ones((), device=loss.device)}, distances

    return eval_step


def batch_norms(model: torch.nn.Module) -> List[torch.nn.BatchNorm2d]:
    """The BatchNorms of ``model`` whose train mode follows Flax: those of
    the ``ConvBNAct`` units and the HRNet head's ``deconv_bn0/1``."""
    return [m for m in model.modules() if isinstance(m, FlaxBatchNorm2d)]


@contextmanager
def _exact_batch_stats(model: torch.nn.Module):
    """Train mode with every BatchNorm's running statistics replaced by the
    batch's own (Flax momentum 0, torch momentum 1); restores both after."""
    bns = batch_norms(model)
    kept = [bn.momentum for bn in bns]
    was_training = model.training
    try:
        for bn in bns:
            bn.momentum = 1.0
        yield bns
    finally:
        for bn, m in zip(bns, kept):
            bn.momentum = m
        model.train(was_training)


@torch.no_grad()
def recalibrate_batch_stats(state: SegTrainState, batches: Iterable[torch.Tensor]) -> SegTrainState:
    """Exact BatchNorm running-stat recalibration, in place.

    With momentum 0.99 the running statistics need ~500 steps to leave
    their init; short runs and fine-tunes evaluate garbage until they are
    recalibrated. One train-mode forward per batch with momentum 0 gives
    each batch's exact statistics (mean, biased variance); they are averaged
    over ``batches`` and written back. (Averaging per-batch variances
    slightly under-counts the between-batch variance of the means;
    negligible for iid batches.)"""
    model = state.model
    acc: Optional[List[torch.Tensor]] = None
    n = 0
    with _exact_batch_stats(model.train()) as bns:
        # the buffers, updated in place by each forward
        stats = [t for bn in bns for t in (bn.running_mean, bn.running_var)]
        for images in batches:
            model(images)
            acc = ([t.clone() for t in stats] if acc is None
                   else [a.add_(t) for a, t in zip(acc, stats)])
            n += 1
        for t, a in zip(stats, acc or []):
            t.copy_(a / n)
    return state


class EarlyStopping:
    """Max/min-mode early stopping with best-state restore. The best
    state's parameters and statistics are kept on the host, so device
    memory is not doubled."""

    def __init__(self, patience: int = 15, min_delta: float = 0.0, mode: str = "max") -> None:
        if mode not in ("max", "min"):
            raise ValueError(f"early stopping mode {mode!r}: want 'max' or 'min'")
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False
        self._best_state_host: Optional[Dict[str, torch.Tensor]] = None

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return value > self.best + self.min_delta
        return value < self.best - self.min_delta

    def __call__(self, value: float, state: Any = None) -> bool:
        """Returns True when training should stop."""
        if self._improved(value):
            self.best = value
            self.counter = 0
            if state is not None:
                self._best_state_host = {k: v.detach().to("cpu", copy=True)
                                         for k, v in state.model.state_dict().items()}
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop

    def restore_best(self, state):
        """``state`` with the best seen parameters and statistics (in place)."""
        if self._best_state_host is not None:
            state.model.load_state_dict(self._best_state_host)
        return state
