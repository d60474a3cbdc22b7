"""MobileNetV3-Large backbone with LR-ASPP feature taps (counterpart of the
JAX package's ``models/mobilenetv3.py``).

torchvision ``mobilenet_v3_large(dilated=True)`` semantics: 15
inverted-residual rows; the dilated tail turns the last downsample into
dilation-2 convs so the high-level features sit at output-stride 16.
Taps: ``low`` after row 3 (40 ch, stride 8), ``high`` after the final 1x1
conv (960 ch, stride 16). Submodule names mirror the Flax tree (``stem``,
``block0`` .. ``block14``, ``head_conv``) so the weight bridge maps
names one to one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from mtg_card_image_segmentation_tpu_torch.models.layers import (
    BN_MOMENTUM,
    ConvBNAct,
    InvertedResidual,
    make_divisible,
)

# (kernel, expanded, out, use_se, act, stride, dilated_tail)
# fmt: off
MOBILENET_V3_LARGE_ROWS: List[Tuple[int, int, int, bool, str, int, bool]] = [
    (3,  16,  16, False, "relu",      1, False),
    (3,  64,  24, False, "relu",      2, False),   # C1 -> stride 4
    (3,  72,  24, False, "relu",      1, False),
    (5,  72,  40, True,  "relu",      2, False),   # C2 -> stride 8   [low tap]
    (5, 120,  40, True,  "relu",      1, False),
    (5, 120,  40, True,  "relu",      1, False),
    (3, 240,  80, False, "hardswish", 2, False),   # C3 -> stride 16
    (3, 200,  80, False, "hardswish", 1, False),
    (3, 184,  80, False, "hardswish", 1, False),
    (3, 184,  80, False, "hardswish", 1, False),
    (3, 480, 112, True,  "hardswish", 1, False),
    (3, 672, 112, True,  "hardswish", 1, False),
    (5, 672, 160, True,  "hardswish", 2, True),    # C4 -> dilated, stays stride 16
    (5, 960, 160, True,  "hardswish", 1, True),
    (5, 960, 160, True,  "hardswish", 1, True),
]
# fmt: on

LOW_TAP_ROW = 3  # first 40-channel block (torchvision stage_indices[-4])
LOW_CHANNELS = 40
HIGH_CHANNELS = 960


class MobileNetV3Backbone(nn.Module):
    """NHWC (B, H, W, 3) -> {"low": (B, H/8, W/8, 40),
    "high": (B, H/16, W/16, 960)}."""

    def __init__(self, dilated: bool = True, fold_bn: bool = False,
                 expanded_overrides: Optional[Sequence[Optional[int]]] = None,
                 bn_momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.stem = ConvBNAct(3, 16, 3, stride=2, act="hardswish",
                              fold_bn=fold_bn, bn_momentum=bn_momentum, dtype=dtype)
        cin = 16
        for i, (k, exp, out, se, act, stride, in_tail) in enumerate(
            MOBILENET_V3_LARGE_ROWS
        ):
            eff_exp = exp
            if expanded_overrides is not None:
                eff_exp = expanded_overrides[i] or exp
            self.add_module(f"block{i}", InvertedResidual(
                cin, eff_exp, out, k, stride,
                dilation=2 if (dilated and in_tail) else 1,
                use_se=se, act=act, fold_bn=fold_bn,
                se_features=make_divisible(exp // 4, 8) if se else None,
                bn_momentum=bn_momentum, dtype=dtype,
            ))
            cin = out
        self.head_conv = ConvBNAct(cin, HIGH_CHANNELS, 1, act="hardswish",
                                   fold_bn=fold_bn, bn_momentum=bn_momentum,
                                   dtype=dtype)

    def block(self, i: int) -> InvertedResidual:
        return getattr(self, f"block{i}")

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps: Dict[str, torch.Tensor] = {}
        x = self.stem(x)
        for i in range(len(MOBILENET_V3_LARGE_ROWS)):
            x = self.block(i)(x)
            if i == LOW_TAP_ROW:
                taps["low"] = x
        taps["high"] = self.head_conv(x)
        return taps


def expected_backbone_params(dilated: bool = True) -> int:
    """Independent closed-form parameter count for the backbone (BN counted
    as scale + bias, the Flax ``params`` convention)."""
    total = 3 * 16 * 9 + 2 * 16  # stem conv + BN scale/bias
    in_ch = 16
    for k, exp, out, se, act, stride, _ in MOBILENET_V3_LARGE_ROWS:
        if exp != in_ch:
            total += in_ch * exp + 2 * exp  # expand 1x1 + BN
        total += exp * k * k + 2 * exp  # depthwise + BN
        if se:
            sq = make_divisible(exp // 4, 8)
            total += exp * sq + sq + sq * exp + exp  # fc1/fc2 with bias
        total += exp * out + 2 * out  # project 1x1 + BN
        in_ch = out
    total += in_ch * HIGH_CHANNELS + 2 * HIGH_CHANNELS  # final 1x1 + BN
    return total
