"""Tensor ops; ``ops.kernels`` holds the hand-written CUDA kernels."""

from mtg_card_image_segmentation_tpu_torch.ops.resize import (
    bilinear_resize,
    nearest_resize,
    upsample_add,
)

__all__ = ["bilinear_resize", "nearest_resize", "upsample_add"]
