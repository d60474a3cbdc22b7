"""Plain reference of ``seg-mnv3l-lraspp``: MobileNetV3-Large (dilated tail)
with the LR-ASPP head, in float32 ``torch.nn.functional`` calls, written
from the paper and the configuration file alone.

It takes the Flax-layout numpy trees that the benchmark made from the seed
and works everything out again from them: BatchNorm from its statistics
(nothing folded), the ImageNet normalization of the uint8 input, the
half-pixel bilinear upsampling of the head and of the logits, and the
per-pixel class by arg-max. TF32 is off while it runs.

``precision="fp8"`` is the usual fp8 recipe, the control that the
comparison has to fail: each conv's and each product's inputs rounded to
float8 e4m3 under a per-tensor scale, with float32 sums.

``judge`` compares the masks a run served with the reference's classes:
the share of pixels that differ, and the widest gap, the largest
``|score|`` (card minus background logit) of the reference at a pixel
whose class the run got wrong, over the median ``|score|`` of that image.
Rounding moves only pixels whose score lies near zero; a wrong weight, a
wrong layer or a mask from another image moves pixels far from it.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_fp32():
    """TF32 off for cuDNN and cuBLAS, restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def tensors(tree: Dict, device, dtype=torch.float32) -> Dict:
    """The tree with each leaf a tensor on ``device``; 4-d kernels go from
    HWIO to OIHW (a depthwise (k, k, 1, C) becomes (C, 1, k, k))."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tensors(v, device, dtype)
        else:
            t = torch.from_numpy(np.array(v, dtype=np.float32)).to(device=device, dtype=dtype)
            out[k] = t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t
    return out


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


ACT = {"relu": torch.relu, "hardswish": hardswish}


def batch_norm(x, p, s, eps):
    """Inference mode, from the statistics."""
    inv = p["scale"] / torch.sqrt(s["var"] + eps)
    return x * inv[None, :, None, None] + (p["bias"] - s["mean"] * inv)[None, :, None, None]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _same(x):
    return x


class _Ops:
    """conv and product with their inputs rounded by ``q``."""

    def __init__(self, precision: str):
        self.q = fp8 if precision == "fp8" else _same

    def conv(self, x, w, stride=1, dilation=1, groups=1, bias=None):
        pad = (w.shape[-1] - 1) // 2 * dilation
        return F.conv2d(self.q(x), self.q(w), bias, stride, pad, dilation, groups)

    def mm(self, a, w):  # a (B, C) @ a 1x1 kernel (O, C, 1, 1)
        return self.q(a) @ self.q(w.flatten(1)).t()

    def cbr(self, x, p, s, eps, stride=1, dilation=1, groups=1, act=None):
        y = batch_norm(self.conv(x, p["conv"]["kernel"], stride, dilation, groups),
                       p["bn"], s["bn"], eps)
        return ACT[act](y) if act else y


def normalize(cfg: Dict, images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) ImageNet-normalized float32."""
    dev = images_u8.device
    mean = torch.tensor(cfg["image_mean"], device=dev)[None, :, None, None]
    std = torch.tensor(cfg["image_std"], device=dev)[None, :, None, None]
    return (images_u8.permute(0, 3, 1, 2).float() / 255.0 - mean) / std


def logits(cfg: Dict, p: Dict, s: Dict, images_u8: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 2, H, W) float32 logits at full size."""
    return forward(cfg, p, s, normalize(cfg, images_u8), precision)


def forward(cfg: Dict, p: Dict, s: Dict, x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """(B, 3, H, W) normalized images -> (B, 2, H, W) logits at full size."""
    ops = _Ops(precision)
    cbr = ops.cbr
    eps = cfg["bn_eps"]
    h, w = x.shape[2:]
    bp, bs = p["backbone"], s["backbone"]
    _k0, _c0, stride0, act0 = cfg["stem"]
    x = cbr(x, bp["stem"], bs["stem"], eps, stride=stride0, act=act0)
    cin = x.shape[1]
    low = None
    for i, (k, exp, out, se, act, stride, dilated) in enumerate(cfg["rows"]):
        bpi, bsi = bp[f"block{i}"], bs[f"block{i}"]
        dil = 2 if (dilated and cfg["dilated_tail"]) else 1
        st = 1 if dil > 1 else stride
        y = x if "expand" not in bpi else cbr(x, bpi["expand"], bsi["expand"], eps, act=act)
        y = cbr(y, bpi["depthwise"], bsi["depthwise"], eps, stride=st, dilation=dil,
                groups=y.shape[1], act=act)
        if se:
            g = y.mean(dim=(2, 3))
            f1, f2 = bpi["se"]["fc1"], bpi["se"]["fc2"]
            g = torch.relu(ops.mm(g, f1["kernel"]) + f1["bias"])
            g = hardsigmoid(ops.mm(g, f2["kernel"]) + f2["bias"])
            y = y * g[:, :, None, None]
        y = cbr(y, bpi["project"], bsi["project"], eps)
        x = y + x if (st == 1 and cin == out) else y
        cin = out
        if i == cfg["low_tap_row"]:
            low = x
    high = cbr(x, bp["head_conv"], bs["head_conv"], eps, act="hardswish")
    hp, hs = p["head"], s["head"]
    feat = cbr(high, hp["cbr"], hs["cbr"], eps, act="relu")
    gate = torch.sigmoid(ops.mm(high.mean(dim=(2, 3)), hp["scale"]["kernel"]))
    feat = feat * gate[:, :, None, None]
    feat = F.interpolate(feat, size=low.shape[2:], mode="bilinear", align_corners=False)
    lc, hc = hp["low_classifier"], hp["high_classifier"]
    out = ops.conv(low, lc["kernel"], bias=lc["bias"]) + ops.conv(feat, hc["kernel"], bias=hc["bias"])
    return F.interpolate(out, size=(h, w), mode="bilinear", align_corners=False)


def calibrate(cfg: Dict, params: Dict, stats: Dict, images_u8: torch.Tensor) -> None:
    """Shift the card class's bias of the low classifier (in place) by the
    median score of ``images_u8``, so that seeded weights split those
    images' pixels about evenly between the classes. Random weights
    otherwise leave the score of every pixel on one side of zero, where no
    mask shows what rounding did."""
    with ieee_fp32(), torch.no_grad():
        p, s = tensors(params, images_u8.device), tensors(stats, images_u8.device)
        lg = logits(cfg, p, s, images_u8)
        med = float((lg[:, 1] - lg[:, 0]).median())
    bias = params["head"]["low_classifier"]["bias"]
    bias[1] = np.float32(bias[1] - med)


def masks(cfg: Dict, p: Dict, s: Dict, images_u8: torch.Tensor,
          precision: str = "fp32") -> torch.Tensor:
    """(B, H, W) uint8 classes (arg-max, ties to class 0) from tensor
    trees (``tensors``)."""
    lg = logits(cfg, p, s, images_u8, precision)
    return (lg[:, 1] > lg[:, 0]).to(torch.uint8)


def judge(cfg: Dict, params: Dict, stats: Dict, inputs: np.ndarray, masks: np.ndarray,
          device, block: int = 16) -> Dict[str, float]:
    """Compare served (N, H, W) uint8 masks with the reference's classes of
    the (N, H, W, 3) uint8 inputs they were served for."""
    with ieee_fp32(), torch.no_grad():
        p, s = tensors(params, device), tensors(stats, device)
        wrong, total, gap = 0, 0, 0.0
        for i in range(0, len(inputs), block):
            x = torch.from_numpy(np.ascontiguousarray(inputs[i:i + block])).to(device)
            lg = logits(cfg, p, s, x)
            score = lg[:, 1] - lg[:, 0]
            ref = (score > 0).to(torch.uint8)  # arg-max, ties to class 0
            got = torch.from_numpy(np.ascontiguousarray(masks[i:i + block])).to(device)
            bad = got != ref
            wrong += int(bad.sum())
            total += bad.numel()
            scale = score.abs().flatten(1).median(dim=1).values.clamp_min(1e-30)
            rel = torch.where(bad, score.abs() / scale[:, None, None], torch.zeros_like(score))
            gap = max(gap, float(rel.max()))
    return {"mask_mismatch": wrong / max(total, 1), "mask_gap": gap}
