"""YOLO12n-pose corner detector, NHWC (counterpart of the JAX package's
``models/yolo12_pose.py``; module names follow its Flax tree).

The ultralytics ``yolo12n-pose.yaml`` graph at scale n (depth 0.5, width
0.25): Conv/C3k2/A2C2f backbone with area attention, PAN-style head,
anchor-free Detect + Pose head with DFL box regression and (K, 3) keypoint
regression per anchor. ``decode_predictions`` and ``top1_detection`` turn
the three levels' raw outputs into one card's box and four corners.

Numerics follow the reference: convs in ``dtype``, BatchNorm (eps 1e-3,
Flax momentum 0.97; train mode moves the running statistics as Flax does,
eval mode reads them) and the SiLU after it in float32, residual sums in
float32 and cast once, the attention softmax in float32, the level outputs
and the whole decode in float32 (or float64, where the level outputs'
``.float()`` gives float64, as in the float64 gradient pass of
``training.loop.grads_float64``). Area attention is plain softmax attention
over spatial tokens split into ``area`` groups, in stock matrix products,
as the reference leaves it to its compiler.

``fold_bn=True`` is the inference layout of ``export/fold_bn.py``'s folded
tree: no BatchNorm, every conv carries the folded bias (the model the
export gates hold the ONNX graph to). The head's last 1x1 convs carry the
reference's 1 % priors in ``bias_prior`` (every class logit and each
keypoint's confidence at -4.595), which ``utils.params.init_flax_defaults``
gives a model trained from scratch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.models.layers import ConvBNAct, nchw, nhwc
from mtg_card_image_segmentation_tpu_torch.ops.heatmap import (
    _first_arg,
    canonicalize_corners,
    quad_plausible,
)
from mtg_card_image_segmentation_tpu_torch.ops.resize import nearest_resize

# scale n
WIDTH = 0.25
DEPTH = 0.5
REG_MAX = 16
# Flax's convention (torch's 0.03): the reference's nn.BatchNorm(momentum=0.97)
BN_MOMENTUM = 0.97
# the head's 1 % prior (ultralytics bias_init) on the class logits and the
# keypoint confidences: keeps the dense BCE and focal terms sane from step 0
PRIOR_LOGIT = -4.595

STRIDES = (8, 16, 32)
# predicted keypoint offsets are in units of KPT_OFFSET_SCALE pixels at
# every level, so localization precision does not depend on the level
KPT_OFFSET_SCALE = 8.0
# two decoded corners closer than this count as one physical corner during
# the joint decode (card corners are >= 100 px apart at 640)
KPT_COLLISION_PX = 24.0
# a decoded quadrilateral below this area (input px^2) cannot be a card
KPT_MIN_AREA_PX2 = 4.0 * KPT_COLLISION_PX**2
# bonus for an assignment whose points already are in canonical identity
# order (TL, TR, BR, BL): it agrees with the head's own labeling. Larger
# than the marginal gaps a rotated-identity pick with one garbage corner can
# win by, far below the >= 0.5 advantage of genuinely swapped predictions.
KPT_ORDER_BONUS = 0.25


def _c(ch: int, max_channels: int = 1024) -> int:
    return int(min(ch, max_channels) * WIDTH)


def _n(n: int) -> int:
    return max(1, round(n * DEPTH))


class ConvBNSiLU(ConvBNAct):
    """Conv -> BatchNorm -> SiLU (ultralytics ``Conv``), symmetric
    ``(k-1)//2`` padding."""

    def __init__(self, in_features: int, features: int, kernel: int = 1,
                 stride: int = 1, groups: int = 1, act: bool = True,
                 fold_bn: bool = False, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__(in_features, features, kernel, stride=stride, groups=groups,
                         act="silu" if act else None, fold_bn=fold_bn,
                         bn_momentum=BN_MOMENTUM, dtype=dtype)


class Conv1x1(nn.Conv2d):
    """A plain 1x1 conv with a bias (the head's last layers), NHWC in and
    out, computed in ``dtype`` with the bias added after the conv.
    ``bias_prior`` (None: zeros) is the bias a model trained from scratch
    starts from."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 bias_prior: Optional[torch.Tensor] = None) -> None:
        super().__init__(in_features, features, 1, bias=True)
        self.dtype = dtype
        self.bias_prior = bias_prior

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(nchw(x.to(dt)), self.weight.to(dt))
        return nhwc(y + self.bias.to(dt)[:, None, None])


class Bottleneck(nn.Module):
    def __init__(self, in_features: int, features: int, shortcut: bool = True,
                 e: float = 0.5, k1: int = 3, k2: int = 3, fold_bn: bool = False,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        hidden = int(features * e)
        kw = dict(fold_bn=fold_bn, dtype=dtype)
        self.dtype = dtype
        self.cv1 = ConvBNSiLU(in_features, hidden, k1, **kw)
        self.cv2 = ConvBNSiLU(hidden, features, k2, **kw)
        self.add = shortcut and in_features == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        if self.add:
            y = (y.float() + x.float()).to(self.dtype)
        return y


class C3k(nn.Module):
    def __init__(self, in_features: int, features: int, n: int = 2, shortcut: bool = True,
                 fold_bn: bool = False, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        c_ = features // 2
        kw = dict(fold_bn=fold_bn, dtype=dtype)
        self.n = n
        self.cv1 = ConvBNSiLU(in_features, c_, 1, **kw)
        self.cv2 = ConvBNSiLU(in_features, c_, 1, **kw)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut, e=1.0, **kw))
        self.cv3 = ConvBNSiLU(2 * c_, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x), self.cv2(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, b], dim=-1))


class C3k2(nn.Module):
    """C2f-style split block (ultralytics C3k2)."""

    def __init__(self, in_features: int, features: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, shortcut: bool = True, fold_bn: bool = False,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        c = int(features * e)
        kw = dict(fold_bn=fold_bn, dtype=dtype)
        self.c, self.n = c, n
        self.cv1 = ConvBNSiLU(in_features, 2 * c, 1, **kw)
        for i in range(n):
            self.add_module(f"m{i}", C3k(c, c, 2, shortcut, **kw) if c3k
                            else Bottleneck(c, c, shortcut, e=0.5, **kw))
        self.cv2 = ConvBNSiLU((2 + n) * c, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        ys = [y[..., :self.c], y[..., self.c:]]
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, dim=-1))


class AAttn(nn.Module):
    """Area attention (ultralytics AAttn): softmax attention over spatial
    tokens within ``area`` horizontal strips + depthwise positional conv."""

    def __init__(self, dim: int, num_heads: int, area: int = 1, fold_bn: bool = False,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kw = dict(fold_bn=fold_bn, dtype=dtype)
        self.dim, self.num_heads, self.area, self.dtype = dim, num_heads, area, dtype
        self.qkv = ConvBNSiLU(dim, dim * 3, 1, act=False, **kw)
        self.pe = ConvBNSiLU(dim, dim, 7, groups=dim, act=False, **kw)
        self.proj = ConvBNSiLU(dim, dim, 1, act=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        n = h * w
        if n % self.area:
            raise ValueError(f"{h}x{w} tokens not divisible by area {self.area}")
        head_dim = self.dim // self.num_heads
        t = self.qkv(x).reshape(b * self.area, n // self.area, 3, self.num_heads, head_dim)
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * head_dim**-0.5
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, h, w, self.dim)
        out = out + self.pe(v.reshape(b, h, w, self.dim))
        return self.proj(out)


class ABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2, area: int = 1,
                 fold_bn: bool = False, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kw = dict(fold_bn=fold_bn, dtype=dtype)
        self.dtype = dtype
        self.attn = AAttn(dim, num_heads, area, **kw)
        hidden = int(dim * mlp_ratio)
        self.mlp1 = ConvBNSiLU(dim, hidden, 1, **kw)
        self.mlp2 = ConvBNSiLU(hidden, dim, 1, act=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x.float() + self.attn(x).float()).to(self.dtype)
        y = self.mlp2(self.mlp1(x))
        return (x.float() + y.float()).to(self.dtype)


class A2C2f(nn.Module):
    def __init__(self, in_features: int, features: int, n: int = 1, a2: bool = True,
                 area: int = 1, mlp_ratio: float = 2.0, e: float = 0.5,
                 fold_bn: bool = False, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        c_ = int(features * e)
        kw = dict(fold_bn=fold_bn, dtype=dtype)
        self.n, self.a2 = n, a2
        self.cv1 = ConvBNSiLU(in_features, c_, 1, **kw)
        for i in range(n):
            if a2:
                for j in range(2):
                    self.add_module(f"m{i}_{j}", ABlock(c_, max(1, c_ // 32), mlp_ratio,
                                                        area, **kw))
            else:
                self.add_module(f"m{i}", C3k(c_, c_, 2, **kw))
        self.cv2 = ConvBNSiLU((1 + n) * c_, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for i in range(self.n):
            z = ys[-1]
            if self.a2:
                for j in range(2):
                    z = getattr(self, f"m{i}_{j}")(z)
            else:
                z = getattr(self, f"m{i}")(z)
            ys.append(z)
        return self.cv2(torch.cat(ys, dim=-1))


class YOLO12PoseBackboneHead(nn.Module):
    """Full yolo12n-pose graph; returns the three levels' raw head outputs,
    float32 (B, h, w, 4*REG_MAX + classes + keypoints*kpt_dim)."""

    def __init__(self, num_classes: int = 1, num_keypoints: int = 4, kpt_dim: int = 3,
                 fold_bn: bool = False, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kw = dict(fold_bn=fold_bn, dtype=dtype)
        # --- backbone (yaml rows 0-8) ---
        self.l0 = ConvBNSiLU(3, _c(64), 3, 2, **kw)  # P1/2
        self.l1 = ConvBNSiLU(_c(64), _c(128), 3, 2, **kw)  # P2/4
        self.l2 = C3k2(_c(128), _c(256), _n(2), False, 0.25, **kw)
        self.l3 = ConvBNSiLU(_c(256), _c(256), 3, 2, **kw)  # P3/8
        self.l4 = C3k2(_c(256), _c(512), _n(2), False, 0.25, **kw)
        self.l5 = ConvBNSiLU(_c(512), _c(512), 3, 2, **kw)  # P4/16
        self.l6 = A2C2f(_c(512), _c(512), _n(4), True, 4, **kw)
        self.l7 = ConvBNSiLU(_c(512), _c(1024), 3, 2, **kw)  # P5/32
        self.l8 = A2C2f(_c(1024), _c(1024), _n(4), True, 1, **kw)
        # --- head (yaml rows 9-20) ---
        self.l11 = A2C2f(_c(1024) + _c(512), _c(512), _n(2), False, **kw)
        self.l14 = A2C2f(_c(512) + _c(512), _c(256), _n(2), False, **kw)
        self.l15 = ConvBNSiLU(_c(256), _c(256), 3, 2, **kw)
        self.l17 = A2C2f(_c(256) + _c(512), _c(512), _n(2), False, **kw)
        self.l18 = ConvBNSiLU(_c(512), _c(512), 3, 2, **kw)
        self.l20 = C3k2(_c(512) + _c(1024), _c(1024), _n(2), True, **kw)
        # --- Pose head (Detect + kpt branch) per level ---
        nk = num_keypoints * kpt_dim
        chans = (_c(256), _c(512), _c(1024))
        ch0 = chans[0]
        c2 = max(16, ch0 // 4, REG_MAX * 4)
        c3 = max(ch0, min(num_classes, 100))
        c4 = max(ch0 // 4, nk)
        cls_prior = torch.full((num_classes,), PRIOR_LOGIT)
        kpt_prior = torch.zeros(nk)
        if kpt_dim == 3:
            kpt_prior[2::3] = PRIOR_LOGIT
        for li, ch in enumerate(chans):
            self.add_module(f"box{li}_0", ConvBNSiLU(ch, c2, 3, **kw))
            self.add_module(f"box{li}_1", ConvBNSiLU(c2, c2, 3, **kw))
            self.add_module(f"box{li}_2", Conv1x1(c2, 4 * REG_MAX, dtype))
            # v10-style lightweight cls head (depthwise + 1x1 pairs)
            self.add_module(f"cls{li}_0dw", ConvBNSiLU(ch, ch, 3, groups=ch, **kw))
            self.add_module(f"cls{li}_0pw", ConvBNSiLU(ch, c3, 1, **kw))
            self.add_module(f"cls{li}_1dw", ConvBNSiLU(c3, c3, 3, groups=c3, **kw))
            self.add_module(f"cls{li}_1pw", ConvBNSiLU(c3, c3, 1, **kw))
            self.add_module(f"cls{li}_2", Conv1x1(c3, num_classes, dtype, cls_prior))
            self.add_module(f"kpt{li}_0", ConvBNSiLU(ch, c4, 3, **kw))
            self.add_module(f"kpt{li}_1", ConvBNSiLU(c4, c4, 3, **kw))
            self.add_module(f"kpt{li}_2", Conv1x1(c4, nk, dtype, kpt_prior))

    def _seq(self, x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        for name in names:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.l2(self.l1(self.l0(x)))
        p3_bb = self.l4(self.l3(x))
        p4_bb = self.l6(self.l5(p3_bb))
        p5_bb = self.l8(self.l7(p4_bb))

        up = nearest_resize(p5_bb, p4_bb.shape[1], p4_bb.shape[2])
        p4_mid = self.l11(torch.cat([up, p4_bb], dim=-1))
        up = nearest_resize(p4_mid, p3_bb.shape[1], p3_bb.shape[2])
        p3 = self.l14(torch.cat([up, p3_bb], dim=-1))
        p4 = self.l17(torch.cat([self.l15(p3), p4_mid], dim=-1))
        p5 = self.l20(torch.cat([self.l18(p4), p5_bb], dim=-1))

        outs = []
        for li, feat in enumerate((p3, p4, p5)):
            b = self._seq(feat, [f"box{li}_{i}" for i in range(3)])
            c = self._seq(feat, [f"cls{li}_{s}" for s in ("0dw", "0pw", "1dw", "1pw", "2")])
            k = self._seq(feat, [f"kpt{li}_{i}" for i in range(3)])
            outs.append(torch.cat([b.float(), c.float(), k.float()], dim=-1))
        return outs


def decode_predictions(level_outputs: Sequence[torch.Tensor], num_classes: int = 1,
                       num_keypoints: int = 4, kpt_dim: int = 3):
    """Anchor-free decode, in float32 whatever the network's dtype (in the
    dtype ``Tensor.float`` gives, float64 in a float64 pass): DFL
    expectation -> ltrb -> xyxy boxes; per anchor and keypoint a confidence
    (sigmoid) and a local offset in KPT_OFFSET_SCALE-pixel units around the
    anchor centre. Returns flattened (B, A, 4) boxes, (B, A, classes) scores
    and (B, A, K, 3) keypoints (x, y, conf)."""
    boxes, scores, kpts = [], [], []
    for out, stride in zip(level_outputs, STRIDES):
        out = out.float()
        b, h, w, _ = out.shape
        dt = out.dtype
        bins = torch.arange(REG_MAX, dtype=dt, device=out.device)
        box = out[..., :4 * REG_MAX].reshape(b, h, w, 4, REG_MAX)
        dist = (torch.softmax(box, dim=-1) * bins).sum(-1)  # (b, h, w, 4) ltrb
        cls = out[..., 4 * REG_MAX:4 * REG_MAX + num_classes]
        kpt = out[..., 4 * REG_MAX + num_classes:].reshape(b, h, w, num_keypoints, kpt_dim)
        cx = (torch.arange(w, dtype=dt, device=out.device) + 0.5).expand(h, w)
        cy = (torch.arange(h, dtype=dt, device=out.device) + 0.5)[:, None].expand(h, w)
        x1 = (cx - dist[..., 0]) * stride
        y1 = (cy - dist[..., 1]) * stride
        x2 = (cx + dist[..., 2]) * stride
        y2 = (cy + dist[..., 3]) * stride
        boxes.append(torch.stack([x1, y1, x2, y2], dim=-1).reshape(b, h * w, 4))
        scores.append(torch.sigmoid(cls).reshape(b, h * w, num_classes))
        kx = cx[..., None] * stride + kpt[..., 0] * KPT_OFFSET_SCALE
        ky = cy[..., None] * stride + kpt[..., 1] * KPT_OFFSET_SCALE
        kconf = torch.sigmoid(kpt[..., 2]) if kpt_dim == 3 else torch.ones_like(kx)
        kpts.append(torch.stack([kx, ky, kconf], dim=-1).reshape(b, h * w, num_keypoints, 3))
    return torch.cat(boxes, dim=1), torch.cat(scores, dim=1), torch.cat(kpts, dim=1)


def top1_detection(boxes: torch.Tensor, scores: torch.Tensor, kpts: torch.Tensor):
    """max_det=1 decode (one card): the box of the best detection anchor
    across all levels; keypoints from a joint assignment over each corner
    channel's top-3 greedy-NMS peaks (radius KPT_COLLISION_PX on the decoded
    xy). All 3^K assignments are scored by the joint log-likelihood of their
    corners minus 10 per colliding pair plus KPT_ORDER_BONUS when already in
    canonical order, and gated on quadrilateral plausibility of the
    canonicalized points (distinct, convex, card-sized): the best plausible
    assignment wins; with none plausible the ungated order stands. The
    chosen corners are re-sorted into canonical image order. Returns ((B, 4)
    box, (B,) confidence, (B, K, 3) keypoints)."""
    dev = boxes.device
    conf = scores.amax(-1)  # (B, A)
    idx = _first_arg(conf, 1)  # (B,)
    box = torch.gather(boxes, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
    k_dim = kpts.shape[2]
    n_cand = 3
    flat = kpts.transpose(1, 2)  # (B, K, A, 3)
    xy = flat[..., :2]
    masked = flat[..., 2].float()  # (B, K, A) running NMS mask
    picks = []
    for _ in range(n_cand):
        i = _first_arg(masked, 2)  # (B, K)
        picks.append(i)
        sel = torch.gather(xy, 2, i[..., None, None].expand(-1, -1, 1, 2))  # (B, K, 1, 2)
        d2_a = ((xy - sel) ** 2).sum(-1)  # (B, K, A)
        masked = masked.masked_fill(d2_a < KPT_COLLISION_PX**2, float("-inf"))
    i3 = torch.stack(picks, dim=-1)  # (B, K, n_cand)
    cand = torch.gather(flat, 2, i3[..., None].expand(-1, -1, -1, 3))  # (B, K, n, 3)
    c3 = torch.log(torch.clamp(cand[..., 2].float(), min=1e-6))
    digits = []
    for c in range(n_cand**k_dim):
        q, row = c, []
        for _ in range(k_dim):
            row.append(q % n_cand)
            q //= n_cand
        digits.append(row)
    combos = torch.tensor(digits, device=dev)  # (n^K, K) rank choice per channel
    kk = torch.arange(k_dim, device=dev)[None, :]
    pick = cand[:, kk, combos, :]  # (B, n^K, K, 3)
    conf_sum = c3[:, kk, combos].sum(-1)
    d2 = ((pick[..., None, :, :2] - pick[..., :, None, :2]) ** 2).sum(-1)  # (B, n^K, K, K)
    eye = torch.eye(k_dim, dtype=torch.bool, device=dev)
    penalty = ((d2 < KPT_COLLISION_PX**2) & ~eye).sum(dim=(-1, -2)).float() * 10.0
    n_comb = combos.shape[0]
    flat_pick = pick.reshape(pick.shape[0] * n_comb, k_dim, 3)
    can = canonicalize_corners(flat_pick)
    plaus = quad_plausible(can[..., :2], min_dist=KPT_COLLISION_PX,
                           min_area=KPT_MIN_AREA_PX2).reshape(pick.shape[0], n_comb)
    in_order = (((can[..., :2] - flat_pick[..., :2]) ** 2).sum(-1) < 1.0).all(-1)
    in_order = in_order.reshape(pick.shape[0], n_comb)
    score_c = conf_sum.float() - penalty + KPT_ORDER_BONUS * in_order.float()
    best = _first_arg(torch.where(plaus, score_c, score_c - 1e4), 1)  # (B,)
    kp = torch.gather(pick, 1, best[:, None, None, None].expand(-1, 1, k_dim, 3))[:, 0]
    return box, conf.amax(-1), canonicalize_corners(kp)


class YOLO12Pose(nn.Module):
    """``forward`` returns the decoded (boxes, scores, kpts); ``levels``
    the raw per-level head outputs (what the loss trains)."""

    def __init__(self, num_classes: int = 1, num_keypoints: int = 4, kpt_dim: int = 3,
                 fold_bn: bool = False, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.num_classes, self.num_keypoints, self.kpt_dim = num_classes, num_keypoints, kpt_dim
        self.net = YOLO12PoseBackboneHead(num_classes, num_keypoints, kpt_dim, fold_bn, dtype)

    def levels(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.net(x)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return decode_predictions(self.net(x), self.num_classes, self.num_keypoints,
                                  self.kpt_dim)
