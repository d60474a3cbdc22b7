"""Named augmentation policies, the progressive schedule and test-time
augmentation (counterpart of the JAX package's ``data/aug_policies.py``).

Behavioral spec: train-pose-estimation_yolo12n/augmentation.py: five named
pipelines light/medium/heavy/geometric/color (:41-180), the weighted random
pipeline choice (:206-230), progressive intensity by epoch fraction
(:232-253) and a deterministic TTA transform set (:256-335).

Policies are ``AugmentConfig`` instances, so every pipeline rides the same
on-device implementation (``data/augment.py``). The tables and the
schedule are copies of the JAX module's. The one draw,
:func:`choose_policy`, takes the caller's ``np.random.Generator``, kept
apart from the pure functions as in ``data/augment.py``; :func:`tta_batch`
and :func:`tta_merge_masks` work on tensors on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig

_NONE = dict(
    hflip_prob=0.0, affine_prob=0.0, elastic_prob=0.0, grid_distort_prob=0.0,
    color_jitter_prob=0.0, brightness_contrast_prob=0.0, noise_blur_prob=0.0,
)

POLICIES: Dict[str, AugmentConfig] = {
    "none": AugmentConfig(**_NONE),
    "light": AugmentConfig(
        **{**_NONE, "hflip_prob": 0.5, "affine_prob": 0.3,
           "translate_percent": 0.05, "scale_range": (0.95, 1.05),
           "rotate_limit_deg": 5.0, "color_jitter_prob": 0.3,
           "brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0.05}
    ),
    "medium": AugmentConfig(),  # the reference's default training pipeline
    "heavy": AugmentConfig(
        hflip_prob=0.5, affine_prob=0.9, translate_percent=0.3,
        scale_range=(0.7, 2.2), rotate_limit_deg=30.0,
        elastic_prob=0.5, grid_distort_prob=0.5,
        color_jitter_prob=0.9, brightness=0.3, contrast=0.3,
        saturation=0.3, hue=0.15, brightness_contrast_prob=0.8,
        noise_blur_prob=0.7,
    ),
    "geometric": AugmentConfig(
        **{**_NONE, "hflip_prob": 0.5, "affine_prob": 1.0,
           "translate_percent": 0.25, "scale_range": (0.8, 1.6),
           "rotate_limit_deg": 25.0, "elastic_prob": 0.4,
           "grid_distort_prob": 0.4}
    ),
    "color": AugmentConfig(
        **{**_NONE, "color_jitter_prob": 1.0, "brightness": 0.3,
           "contrast": 0.3, "saturation": 0.3, "hue": 0.15,
           "brightness_contrast_prob": 0.8, "noise_blur_prob": 0.6}
    ),
}

DEFAULT_WEIGHTS: Dict[str, float] = {
    "light": 0.3, "medium": 0.4, "heavy": 0.1, "geometric": 0.1, "color": 0.1,
}


def choose_policy(rng: np.random.Generator, weights: Optional[Dict[str, float]] = None) -> str:
    """Weighted random pipeline choice (augmentation.py:206-230)."""
    weights = weights or DEFAULT_WEIGHTS
    names = list(weights)
    p = np.asarray([weights[n] for n in names], np.float64)
    return str(rng.choice(names, p=p / p.sum()))


def progressive_policy(epoch: int, total_epochs: int) -> str:
    """Intensity schedule by training progress (augmentation.py:232-253):
    first 30% light, 30-70% medium, last 30% heavy."""
    frac = epoch / max(total_epochs, 1)
    if frac < 0.3:
        return "light"
    if frac < 0.7:
        return "medium"
    return "heavy"


def _interp(a: AugmentConfig, b: AugmentConfig, t: float) -> AugmentConfig:
    """Continuous blend between two policies (smoother than the reference's
    3-step schedule; use ``progressive_policy`` for exact parity)."""
    out = {}
    for f in dataclasses.fields(AugmentConfig):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, bool) or isinstance(va, int):
            out[f.name] = va if t < 0.5 else vb
        elif isinstance(va, float):
            out[f.name] = va + (vb - va) * t
        elif isinstance(va, tuple):
            out[f.name] = tuple(x + (y - x) * t for x, y in zip(va, vb))
        else:
            out[f.name] = va
    return AugmentConfig(**out)


def progressive_config(epoch: int, total_epochs: int) -> AugmentConfig:
    frac = epoch / max(total_epochs, 1)
    if frac < 0.5:
        return _interp(POLICIES["light"], POLICIES["medium"], frac * 2)
    return _interp(POLICIES["medium"], POLICIES["heavy"], (frac - 0.5) * 2)


# ---------------------------------------------------------------------------
# TTA: deterministic transform set + inverse mapping for predictions
# ---------------------------------------------------------------------------

TTA_TRANSFORMS: Sequence[str] = (
    "identity", "hflip", "brightness_up", "brightness_down", "contrast_up", "blur",
)


def tta_batch(images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Apply the 6-transform TTA set (augmentation.py:256-335) to a
    (B,H,W,3) [0,1] batch. Returns {name: transformed batch}; the blur is
    ``data/warp.py::gaussian_blur`` with sigma 1 and radius 3."""
    from mtg_card_image_segmentation_tpu_torch.data.warp import gaussian_blur

    sigma = torch.ones(images.shape[0], dtype=torch.float32, device=images.device)
    return {
        "identity": images,
        "hflip": images.flip(2),
        "brightness_up": torch.clamp(images * 1.2, 0, 1),
        "brightness_down": torch.clamp(images * 0.8, 0, 1),
        "contrast_up": torch.clamp((images - 0.5) * 1.3 + 0.5, 0, 1),
        "blur": gaussian_blur(images, sigma, 3),
    }


def tta_merge_masks(per_transform_logits: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Average logits back in the original frame (un-flip 'hflip')."""
    total = None
    for name, logits in per_transform_logits.items():
        if name == "hflip":
            logits = logits.flip(2)
        total = logits if total is None else total + logits
    return total / len(per_transform_logits)
