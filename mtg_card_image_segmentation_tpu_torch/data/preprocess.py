"""ImageNet normalization constants (train/dataset.py:183-185 of the
reference) and the [0,1] -> normalized helper. NHWC tensors."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_only(images01: torch.Tensor) -> torch.Tensor:
    """[0,1] float NHWC -> ImageNet-normalized, float32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images01.device)
    return (images01.float() - mean) / std
