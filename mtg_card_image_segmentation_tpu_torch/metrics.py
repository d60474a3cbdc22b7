"""Streaming segmentation + corner metrics (counterpart of the JAX
package's ``metrics.py``).

1. Per-batch metrics (smooth=1e-6, averaged over batches), the numbers of
   the training logs: ``segmentation_batch_stats`` returns device tensors,
   and ``MetricsAccumulator`` moves them to the host only when it is
   updated.
2. Exact streaming confusion-matrix metrics (``ConfusionAccumulator``): the
   dataset-level numbers evaluation reports.

Corner metrics: accuracy at 3/5/6/10/20 px and mean/median distance.

Under a ``torch.distributed`` process group the per-batch stats and the
confusion counts of the eval steps are the global batch's: their sums are
all-reduced over the ranks, so every rank reports what the JAX step
reports over a data-sharded batch.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.parallel.distributed import all_reduce_sum, is_active

_SMOOTH = 1e-6


def _pred_target_one_hot(logits: torch.Tensor, targets: torch.Tensor, num_classes: int):
    cls = torch.arange(num_classes, device=logits.device)
    pred = torch.argmax(logits, dim=-1)
    return (pred[..., None] == cls).float(), (targets[..., None] == cls).float()


def batch_iou(logits: torch.Tensor, targets: torch.Tensor,
              num_classes: int = 2) -> torch.Tensor:
    """Per-class smoothed IoU for one batch: (C,) tensor."""
    pred_oh, tgt_oh = _pred_target_one_hot(logits, targets, num_classes)
    inter, sums = all_reduce_sum(torch.stack([
        torch.sum(pred_oh * tgt_oh, dim=(0, 1, 2)),
        torch.sum(pred_oh, dim=(0, 1, 2)) + torch.sum(tgt_oh, dim=(0, 1, 2))]))
    union = sums - inter
    return (inter + _SMOOTH) / (union + _SMOOTH)


def batch_dice(logits: torch.Tensor, targets: torch.Tensor,
               num_classes: int = 2) -> torch.Tensor:
    """Per-class smoothed dice for one batch: (C,) tensor."""
    pred_oh, tgt_oh = _pred_target_one_hot(logits, targets, num_classes)
    inter, denom = all_reduce_sum(torch.stack([
        torch.sum(pred_oh * tgt_oh, dim=(0, 1, 2)),
        torch.sum(pred_oh, dim=(0, 1, 2)) + torch.sum(tgt_oh, dim=(0, 1, 2))]))
    return (2.0 * inter + _SMOOTH) / (denom + _SMOOTH)


def batch_pixel_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    right = (pred == targets).float()
    if not is_active():
        return torch.mean(right)
    hits, n = all_reduce_sum(torch.stack([right.sum(), right.new_tensor(right.numel())]))
    return hits / n


def segmentation_batch_stats(loss: torch.Tensor, logits: torch.Tensor,
                             targets: torch.Tensor,
                             num_classes: int = 2) -> Dict[str, torch.Tensor]:
    """One batch's stats as a small dict of device tensors; sum these across
    batches, then call :func:`summarize_batch_stats`."""
    return {
        "loss": loss.detach().float(),
        "iou": batch_iou(logits, targets, num_classes),
        "dice": batch_dice(logits, targets, num_classes),
        "pixel_accuracy": batch_pixel_accuracy(logits, targets),
        "count": torch.ones((), dtype=torch.float32, device=logits.device),
    }


def summarize_batch_stats(acc: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Average accumulated batch stats into the metric dict layout of the
    training logs."""
    n = float(acc["count"])
    iou = np.asarray(acc["iou"]) / n
    dice = np.asarray(acc["dice"]) / n
    out = {
        "loss": float(acc["loss"]) / n,
        "mean_iou": float(iou.mean()),
        "mean_dice": float(dice.mean()),
        "pixel_accuracy": float(acc["pixel_accuracy"]) / n,
    }
    names = ["background", "card"] if iou.shape[0] == 2 else [str(i) for i in range(iou.shape[0])]
    for i, name in enumerate(names):
        out[f"iou_{name}"] = float(iou[i])
        out[f"dice_{name}"] = float(dice[i])
    return out


def to_host(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device stats -> float64 numpy (one transfer per entry)."""
    return {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v,
                          dtype=np.float64)
            for k, v in stats.items()}


class MetricsAccumulator:
    """Host-side running accumulator over per-batch stat dicts."""

    def __init__(self) -> None:
        self._acc: Dict[str, np.ndarray] | None = None

    def update(self, stats: Dict[str, torch.Tensor]) -> None:
        stats = to_host(stats)
        if self._acc is None:
            self._acc = stats
        else:
            self._acc = {k: self._acc[k] + stats[k] for k in self._acc}

    def result(self) -> Dict[str, float]:
        if self._acc is None:
            return {}
        return summarize_batch_stats(self._acc)

    def reset(self) -> None:
        self._acc = None


def confusion_matrix(pred: torch.Tensor, targets: torch.Tensor, num_classes: int = 2,
                     sample_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Exact (C, C) int64 confusion counts, rows = target, cols = pred.

    ``sample_weight``: optional per-image 0/1 weights of shape (B,): padded
    batch rows carry weight 0 so they add no counts. The counts are a
    scatter-add into a fixed (C*C,) vector, which reads nothing back to the
    host (``torch.bincount`` would, for its length)."""
    idx = (targets.long() * num_classes + pred.long()).reshape(-1)
    if sample_weight is None:
        add = torch.ones_like(idx)
    else:
        w = torch.as_tensor(sample_weight, device=idx.device).long()
        add = w.reshape((-1,) + (1,) * (targets.dim() - 1)).expand(targets.shape).reshape(-1)
    counts = torch.zeros(num_classes * num_classes, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, idx, add)
    return counts.reshape(num_classes, num_classes)


def metrics_from_confusion(cm: np.ndarray) -> Dict[str, float]:
    """Per-class precision/recall/F1/IoU + accuracy from a confusion matrix."""
    cm = np.asarray(cm, dtype=np.float64)
    num_classes = cm.shape[0]
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        recall = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(
            precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0
        )
        iou = np.where(tp + fp + fn > 0, tp / (tp + fp + fn), 0.0)
        dice = np.where(2 * tp + fp + fn > 0, 2 * tp / (2 * tp + fp + fn), 0.0)
    out: Dict[str, float] = {
        "pixel_accuracy": float(tp.sum() / max(cm.sum(), 1.0)),
        "mean_iou": float(iou.mean()),
        "mean_dice": float(dice.mean()),
        "mean_f1": float(f1.mean()),
    }
    names = (
        ["background", "card"]
        if num_classes == 2
        else [str(i) for i in range(num_classes)]
    )
    for i, name in enumerate(names):
        out[f"precision_{name}"] = float(precision[i])
        out[f"recall_{name}"] = float(recall[i])
        out[f"f1_{name}"] = float(f1[i])
        out[f"iou_{name}"] = float(iou[i])
        out[f"dice_{name}"] = float(dice[i])
    return out


class ConfusionAccumulator:
    def __init__(self, num_classes: int = 2) -> None:
        self.num_classes = num_classes
        self.cm = np.zeros((num_classes, num_classes), np.int64)

    def update(self, cm_batch) -> None:
        if torch.is_tensor(cm_batch):
            cm_batch = cm_batch.cpu().numpy()
        self.cm += np.asarray(cm_batch, dtype=np.int64)

    def result(self) -> Dict[str, float]:
        return metrics_from_confusion(self.cm)

    def reset(self) -> None:
        self.cm[...] = 0


def corner_distances(pred_xy: torch.Tensor, target_xy: torch.Tensor,
                     image_size: tuple[int, int] | None = None) -> torch.Tensor:
    """Per-corner Euclidean distances, (B, K). ``pred_xy``/``target_xy``:
    (B, K, 2), normalized to [0, 1] when ``image_size`` (H, W) is given
    (distances are then scaled to pixels), else already in pixels."""
    pred = pred_xy.float()
    tgt = target_xy.float()
    if image_size is not None:
        h, w = image_size
        scale = torch.tensor([w, h], dtype=torch.float32, device=pred.device)
        pred = pred * scale
        tgt = tgt * scale
    return torch.sqrt(torch.sum((pred - tgt) ** 2, dim=-1) + 1e-12)


def corner_metrics(distances_px: torch.Tensor,
                   thresholds: Sequence[float] = (3.0, 5.0, 6.0, 10.0, 20.0)
                   ) -> Dict[str, torch.Tensor]:
    """Accuracy@Npx over all corners + mean and median distance, from (B, K)
    pixel distances."""
    flat = distances_px.reshape(-1)
    # jnp.median averages the two middle values of an even count;
    # torch.median takes the lower one
    srt = torch.sort(flat).values
    n = flat.numel()
    median = 0.5 * (srt[(n - 1) // 2] + srt[n // 2])
    out: Dict[str, torch.Tensor] = {
        "mean_corner_distance": torch.mean(distances_px),
        "median_corner_distance": median,
    }
    for t in thresholds:
        out[f"corner_acc_{int(t)}px"] = torch.mean((distances_px <= t).float()) * 100.0
    for k in range(distances_px.shape[1]):
        out[f"corner_{k}_mean_distance"] = torch.mean(distances_px[:, k])
    return out
