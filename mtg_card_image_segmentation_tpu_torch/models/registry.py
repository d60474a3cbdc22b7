"""Model factory (counterpart of the JAX package's ``models/registry.py``).
The port registers the segmentation model and the two corner-pose models
(HRNet heatmaps, YOLO12n-pose). Parameters are float32; ``compute_dtype``
is the dtype the convs run in. ``bn_momentum`` is Flax's convention."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from mtg_card_image_segmentation_tpu_torch.config import ModelConfig, PoseModelConfig

_REGISTRY: Dict[str, Callable[..., Any]] = {}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_models():
    return sorted(_REGISTRY)


def create_model(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model {name!r}; available: {available_models()}")
    return _REGISTRY[name](**kwargs)


def check_param_dtype(param_dtype: str) -> None:
    if param_dtype != "float32":
        raise ValueError(f"the port keeps float32 parameters, not {param_dtype!r}")


@register("lraspp_mobilenet_v3_large")
def _lraspp(num_classes: int = 2, inter_channels: int = 128,
            compute_dtype: str = "bfloat16", param_dtype: str = "float32",
            bn_momentum: float = 0.99, fold_bn: bool = False,
            expanded_overrides=None):
    from mtg_card_image_segmentation_tpu_torch.models.lraspp import (
        CardSegmentationModel,
    )

    check_param_dtype(param_dtype)
    return CardSegmentationModel(
        num_classes=num_classes,
        inter_channels=inter_channels,
        fold_bn=fold_bn,
        expanded_overrides=expanded_overrides,
        bn_momentum=bn_momentum,
        dtype=_DTYPES[compute_dtype],
    )


def from_config(cfg: ModelConfig):
    """The segmentation model of ``cfg`` (train layout: BN not folded, Flax
    momentum 0.99)."""
    return create_model(
        cfg.name,
        num_classes=cfg.num_classes,
        inter_channels=cfg.inter_channels,
        compute_dtype=cfg.compute_dtype,
        param_dtype=cfg.param_dtype,
    )


def pose_from_config(cfg: PoseModelConfig):
    """The HRNet corner model of ``cfg`` (train layout, Flax momentum 0.99).
    The JAX package also builds a momentum-0 copy for the exact BatchNorm
    recalibration; the port recalibrates the model itself
    (``training.loop.recalibrate_batch_stats``)."""
    check_param_dtype(cfg.param_dtype)
    return create_model(
        cfg.name,
        num_keypoints=cfg.num_keypoints,
        heatmap_height=cfg.heatmap_height,
        heatmap_width=cfg.heatmap_width,
        compute_dtype=cfg.compute_dtype,
    )


@register("hrnet_pose")
def _hrnet_pose(num_keypoints: int = 4, heatmap_height: int = 120,
                heatmap_width: int = 160, compute_dtype: str = "bfloat16"):
    from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetPose

    return HRNetPose(
        num_keypoints=num_keypoints,
        heatmap_height=heatmap_height,
        heatmap_width=heatmap_width,
        dtype=_DTYPES[compute_dtype],
    )


@register("yolo12n_pose")
def _yolo12n_pose(num_classes: int = 1, num_keypoints: int = 4, kpt_dim: int = 3,
                  compute_dtype: str = "bfloat16"):
    from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import YOLO12Pose

    return YOLO12Pose(
        num_classes=num_classes,
        num_keypoints=num_keypoints,
        kpt_dim=kpt_dim,
        dtype=_DTYPES[compute_dtype],
    )
