"""Segmentation / pose losses (counterpart of the JAX package's
``losses.py``), pure functions over NHWC logits:

- ``dice_loss``: softmax (float32) -> one-hot -> *globally flattened* dice
  with smooth=1e-6: one dice across batch, classes and pixels, not one per
  class;
- ``cross_entropy_loss``: mean softmax-CE over all pixels, or the weighted
  mean of ``nn.CrossEntropyLoss(weight=...)`` with ``class_weights``;
- ``combined_loss``: w_dice * dice + w_ce * ce;
- ``heatmap_mse_loss``: plain MSE on keypoint heatmaps.

None of them reads a value back to the host. Under a ``torch.distributed``
process group the dice and the cross-entropy are taken over the global
batch, as the JAX package's over a data-sharded batch: their sums are
all-reduced over the ranks (with a backward) before the ratio, so every
rank holds the global loss. The heatmap MSE is a local mean: over equal
local batches, ``DistributedDataParallel``'s gradient average makes it
the global one.
"""

from __future__ import annotations

from typing import Optional

import torch

from mtg_card_image_segmentation_tpu_torch.parallel.distributed import all_reduce_sum, is_active


def _one_hot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot by comparison: a class id outside [0, C) gives a row
    of zeros (as ``jax.nn.one_hot`` does), and no bound is checked on the
    host (``F.one_hot`` would read the ids back)."""
    cls = torch.arange(num_classes, device=targets.device)
    return (targets[..., None] == cls).float()


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              smooth: float = 1e-6) -> torch.Tensor:
    """Global dice loss. ``logits``: (B, H, W, C) raw scores; ``targets``:
    (B, H, W) int class ids."""
    probs = torch.softmax(logits.float(), dim=-1)
    one_hot = _one_hot(targets, logits.shape[-1])
    intersection, denom = all_reduce_sum(torch.stack(
        [torch.sum(probs * one_hot), torch.sum(probs) + torch.sum(one_hot)]))
    dice = (2.0 * intersection + smooth) / (denom + smooth)
    return 1.0 - dice


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over all pixels; with ``class_weights``
    the mean is weighted per torch ``CrossEntropyLoss(weight=...)``."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    idx = targets.long()[..., None]
    nll = -torch.gather(log_probs, -1, idx)[..., 0]
    if class_weights is None:
        if not is_active():
            return torch.mean(nll)
        total, n = all_reduce_sum(torch.stack([torch.sum(nll), nll.new_tensor(nll.numel())]))
        return total / n
    w = class_weights.to(nll.device)[idx[..., 0]]
    total, wsum = all_reduce_sum(torch.stack([torch.sum(nll * w), torch.sum(w)]))
    return total / wsum


def combined_loss(logits: torch.Tensor, targets: torch.Tensor,
                  dice_weight: float = 0.5, ce_weight: float = 0.5,
                  class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return dice_weight * dice_loss(logits, targets) + ce_weight * cross_entropy_loss(
        logits, targets, class_weights
    )


def heatmap_mse_loss(pred_heatmaps: torch.Tensor,
                     target_heatmaps: torch.Tensor) -> torch.Tensor:
    """Mean-squared error over (B, H, W, K) keypoint heatmaps."""
    diff = pred_heatmaps.float() - target_heatmaps.float()
    return torch.mean(diff * diff)
