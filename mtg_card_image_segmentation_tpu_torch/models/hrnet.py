"""HRNet-W18-small backbone + deconv heatmap head, NHWC (counterpart of the
JAX package's ``models/hrnet.py``; module names follow its Flax tree).

Backbone: stem 64 @ stride 4; stage 1 one bottleneck (32 x 4); stages 2-4
grow branches [16, 32, 64, 128] at strides [4, 8, 16, 32], two basic blocks
per branch per stage, and full cross-resolution fusion (strided 3x3 convs
down, 1x1 conv + nearest resize up). Head: 2x [ConvTranspose(256, k4 s2) +
BN + ReLU], 2x [3x3 conv(256) + BN + ReLU], 1x1 -> K heatmaps, half-pixel
bilinear resize to the exact heatmap size.

Numerics follow the reference: convs in ``dtype``, BatchNorm in float32,
residual and fusion sums in float32 and cast once, the final resize in
float32. BatchNorm is not folded: serving runs the model with its
statistics.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.models.layers import (
    BN_EPS,
    BN_MOMENTUM,
    ConvBNAct,
    FlaxBatchNorm2d,
    nchw,
    nhwc,
)
from mtg_card_image_segmentation_tpu_torch.ops.resize import bilinear_resize, nearest_resize

W18_SMALL_CHANNELS: Tuple[Tuple[int, ...], ...] = ((16, 32), (16, 32, 64), (16, 32, 64, 128))
W18_SMALL_BLOCKS = 2
STEM_CHANNELS = 64
STAGE1_PLANES = 32
BOTTLENECK_EXPANSION = 4


class BasicBlock(nn.Module):
    """Two 3x3 convs and a residual (1x1 ``proj`` where widths differ)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvBNAct(in_features, features, 3, act="relu", dtype=dtype)
        self.conv2 = ConvBNAct(features, features, 3, act=None, dtype=dtype)
        self.proj = (ConvBNAct(in_features, features, 1, act=None, dtype=dtype)
                     if in_features != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.proj is not None:
            x = self.proj(x)
        return torch.relu(y.float() + x.float()).to(self.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (``planes * 4`` out) and a residual."""

    def __init__(self, in_features: int, planes: int,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        out_ch = planes * BOTTLENECK_EXPANSION
        self.out_features = out_ch
        self.conv1 = ConvBNAct(in_features, planes, 1, act="relu", dtype=dtype)
        self.conv2 = ConvBNAct(planes, planes, 3, act="relu", dtype=dtype)
        self.conv3 = ConvBNAct(planes, out_ch, 1, act=None, dtype=dtype)
        self.proj = (ConvBNAct(in_features, out_ch, 1, act=None, dtype=dtype)
                     if in_features != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        if self.proj is not None:
            x = self.proj(x)
        return torch.relu(y.float() + x.float()).to(self.dtype)


class FuseLayer(nn.Module):
    """Full cross-resolution fusion: every output branch sums (in float32)
    a contribution from every input branch: ``down{i}_{j}_{s}`` strided 3x3
    convs from a finer branch j < i, ``up{i}_{j}`` 1x1 conv + nearest resize
    from a coarser branch j > i."""

    def __init__(self, channels: Sequence[int], dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        for i, out_ch in enumerate(channels):
            for j, in_ch in enumerate(channels):
                if j < i:
                    for s in range(i - j):
                        last = s == i - j - 1
                        self.add_module(f"down{i}_{j}_{s}", ConvBNAct(
                            in_ch, out_ch if last else in_ch, 3, stride=2,
                            act=None if last else "relu", dtype=dtype))
                elif j > i:
                    self.add_module(f"up{i}_{j}", ConvBNAct(
                        in_ch, out_ch, 1, act=None, dtype=dtype))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i in range(self.n):
            acc = None
            for j, x in enumerate(xs):
                if j == i:
                    y = x
                elif j < i:
                    y = x
                    for s in range(i - j):
                        y = getattr(self, f"down{i}_{j}_{s}")(y)
                else:
                    y = getattr(self, f"up{i}_{j}")(x)
                    y = nearest_resize(y, xs[i].shape[1], xs[i].shape[2])
                acc = y.float() if acc is None else acc + y.float()
            outs.append(torch.relu(acc).to(self.dtype))
        return outs


class HRNetBackbone(nn.Module):
    """(B, H, W, 3) -> four feature maps at strides [4, 8, 16, 32] with
    channels [16, 32, 64, 128]."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.stem1 = ConvBNAct(3, STEM_CHANNELS, 3, stride=2, act="relu", dtype=dtype)
        self.stem2 = ConvBNAct(STEM_CHANNELS, STEM_CHANNELS, 3, stride=2, act="relu",
                               dtype=dtype)
        self.stage1_block0 = Bottleneck(STEM_CHANNELS, STAGE1_PLANES, dtype=dtype)
        widths = [self.stage1_block0.out_features]
        for stage, channels in enumerate(W18_SMALL_CHANNELS):
            for b, ch in enumerate(channels):
                if b < len(widths):
                    if widths[b] != ch:
                        self.add_module(f"t{stage}_b{b}", ConvBNAct(
                            widths[b], ch, 3, act="relu", dtype=dtype))
                else:  # a new, coarser branch from the coarsest one so far
                    self.add_module(f"t{stage}_b{b}", ConvBNAct(
                        widths[-1], ch, 3, stride=2, act="relu", dtype=dtype))
                for blk in range(W18_SMALL_BLOCKS):
                    self.add_module(f"s{stage}_b{b}_blk{blk}", BasicBlock(ch, ch, dtype=dtype))
            self.add_module(f"fuse{stage}", FuseLayer(channels, dtype=dtype))
            widths = list(channels)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stage1_block0(self.stem2(self.stem1(x)))
        branches = [x]
        for stage, channels in enumerate(W18_SMALL_CHANNELS):
            new_branches = []
            for b in range(len(channels)):
                src = branches[b] if b < len(branches) else branches[-1]
                transition = getattr(self, f"t{stage}_b{b}", None)
                if transition is not None:
                    src = transition(src)
                for blk in range(W18_SMALL_BLOCKS):
                    src = getattr(self, f"s{stage}_b{b}_blk{blk}")(src)
                new_branches.append(src)
            branches = getattr(self, f"fuse{stage}")(new_branches)
        return branches


class HRNetPoseHead(nn.Module):
    """Deconv heatmap head: two up-convs to ``width``, two 3x3 refinement
    convs, 1x1 -> K, bilinear resize (float32) to the exact heatmap size."""

    def __init__(self, in_features: int = 128, num_keypoints: int = 4,
                 heatmap_height: int = 120, heatmap_width: int = 160,
                 width: int = 256, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        self.heatmap_hw = (heatmap_height, heatmap_width)
        cin = in_features
        for i in range(2):
            # k4 s2 with padding 1 is the reference's ``SAME`` transpose conv
            self.add_module(f"deconv{i}", nn.ConvTranspose2d(
                cin, width, 4, stride=2, padding=1, bias=False))
            self.add_module(f"deconv_bn{i}", FlaxBatchNorm2d(
                width, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM))
            cin = width
        self.conv0 = ConvBNAct(width, width, 3, act="relu", dtype=dtype)
        self.conv1 = ConvBNAct(width, width, 3, act="relu", dtype=dtype)
        self.final = nn.Conv2d(width, num_keypoints, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            deconv = getattr(self, f"deconv{i}")
            y = F.conv_transpose2d(nchw(x.to(self.dtype)), deconv.weight.to(self.dtype),
                                   None, stride=2, padding=1)
            y = getattr(self, f"deconv_bn{i}")(y.float())
            x = nhwc(torch.relu(y).to(self.dtype))
        x = self.conv1(self.conv0(x))
        # the bias is added after the conv's own rounding, as in ConvBNAct
        y = F.conv2d(nchw(x), self.final.weight.to(self.dtype), None)
        y = y + self.final.bias.to(self.dtype)[:, None, None]
        return bilinear_resize(nhwc(y).float(), *self.heatmap_hw)


class HRNetPose(nn.Module):
    """Corner-heatmap model: (B, H, W, 3) normalized images -> (B, hm_h,
    hm_w, K) float32 heatmaps, from the deepest backbone branch."""

    def __init__(self, num_keypoints: int = 4, heatmap_height: int = 120,
                 heatmap_width: int = 160, feature_index: int = 3,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.feature_index = feature_index
        self.backbone = HRNetBackbone(dtype=dtype)
        self.head = HRNetPoseHead(
            W18_SMALL_CHANNELS[-1][feature_index], num_keypoints,
            heatmap_height, heatmap_width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(x)[self.feature_index])
