"""Pruning, structured and unstructured, and physical channel removal."""

from mtg_card_image_segmentation_tpu_torch.compression.prune import (
    apply_masks,
    magnitude_prune,
    masked_optimizer,
    sparsity_report,
    structured_channel_prune,
)

__all__ = [
    "magnitude_prune",
    "structured_channel_prune",
    "apply_masks",
    "masked_optimizer",
    "sparsity_report",
]
