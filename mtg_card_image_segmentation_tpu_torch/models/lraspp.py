"""LR-ASPP segmentation head + full card-segmentation model (counterpart
of the JAX package's ``models/lraspp.py``).

Head dataflow (reference train/model.py:124-142):
    x = cbr(high)                       # 3x3 conv + BN + ReLU, 128ch @ s16
    s = sigmoid(1x1(globalpool(high)))  # image-level gate, no bias
    x = x * s
    x = bilinear_up(x, low.shape)       # s16 -> s8, align_corners=False
    out = low_cls(low) + high_cls(x)    # 1x1 classifiers, fp32 sum @ s8
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.models.layers import BN_MOMENTUM, ConvBNAct
from mtg_card_image_segmentation_tpu_torch.models.mobilenetv3 import (
    HIGH_CHANNELS,
    LOW_CHANNELS,
    MobileNetV3Backbone,
)
from mtg_card_image_segmentation_tpu_torch.parallel import space


def conv1x1(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """1x1 conv of NHWC ``x`` as a matmul over channels, in ``dtype``."""
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.linear(x.to(dtype), conv.weight.to(dtype).flatten(1), b)


class LRASPPHead(nn.Module):
    def __init__(self, num_classes: int = 2, inter_channels: int = 128,
                 fold_bn: bool = False, bn_momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        self.cbr = ConvBNAct(HIGH_CHANNELS, inter_channels, 3, act="relu",
                             fold_bn=fold_bn, bn_momentum=bn_momentum, dtype=dtype)
        self.scale = nn.Conv2d(HIGH_CHANNELS, inter_channels, 1, bias=False)
        self.low_classifier = nn.Conv2d(LOW_CHANNELS, num_classes, 1)
        self.high_classifier = nn.Conv2d(inter_channels, num_classes, 1)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        x = self.cbr(high)
        # (B, C) pooled in fp32 (float64 in a float64 pass)
        s = space.mean_hw(high, torch.promote_types(high.dtype, torch.float32))
        s = torch.sigmoid(conv1x1(s, self.scale, self.dtype).float())
        x = x.float() * s[:, None, None, :]
        x = space.bilinear_resize(x, low.shape[1], low.shape[2])
        low_logits = conv1x1(low, self.low_classifier, self.dtype)
        high_logits = conv1x1(x, self.high_classifier, self.dtype)
        return low_logits.float() + high_logits.float()


class CardSegmentationModel(nn.Module):
    """(B, H, W, 3) normalized float -> (B, H, W, num_classes) fp32 logits
    (class 0 background, class 1 card)."""

    def __init__(self, num_classes: int = 2, inter_channels: int = 128,
                 fold_bn: bool = False,
                 expanded_overrides: Optional[Sequence[Optional[int]]] = None,
                 bn_momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.backbone = MobileNetV3Backbone(
            dilated=True, fold_bn=fold_bn,
            expanded_overrides=expanded_overrides, bn_momentum=bn_momentum,
            dtype=dtype,
        )
        self.head = LRASPPHead(num_classes, inter_channels, fold_bn=fold_bn,
                               bn_momentum=bn_momentum, dtype=dtype)

    def logits_s8(self, x: torch.Tensor) -> torch.Tensor:
        """Head logits at stride 8, before the final upsample."""
        taps = self.backbone(x)
        return self.head(taps["low"], taps["high"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return space.bilinear_resize(self.logits_s8(x), x.shape[1], x.shape[2])
