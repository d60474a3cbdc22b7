"""On-device preprocessing, NHWC: uint8 -> resize -> ImageNet normalize
(counterpart of the JAX package's ``data/preprocess.py``; constants from
train/dataset.py:183-185 of the reference). Decode stays on the host."""

from __future__ import annotations

from typing import Optional

import torch

from mtg_card_image_segmentation_tpu_torch.ops.resize import bilinear_resize, nearest_resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_only(images01: torch.Tensor) -> torch.Tensor:
    """[0,1] float NHWC -> ImageNet-normalized, float32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images01.device)
    return (images01.float() - mean) / std


def preprocess_batch(images_u8: torch.Tensor, masks_u8: Optional[torch.Tensor],
                     out_h: int, out_w: int, normalize: bool = True):
    """(B,H,W,3) uint8 [+ (B,H,W) uint8 mask] -> float32 images resized to
    (out_h, out_w) (half-pixel bilinear), ImageNet-normalized when
    ``normalize``, [+ int32 {0,1} masks: binarized > 127
    (train/dataset.py:76), nearest-resized]."""
    x = bilinear_resize(images_u8.float() / 255.0, out_h, out_w)
    if normalize:
        x = normalize_only(x)
    if masks_u8 is None:
        return x
    m = (masks_u8 > 127).float()[..., None]
    return x, nearest_resize(m, out_h, out_w)[..., 0].to(torch.int32)
