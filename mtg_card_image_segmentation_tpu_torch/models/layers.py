"""Shared NHWC building blocks (counterpart of the JAX package's
``models/layers.py``).

Public functions and modules take and return NHWC tensors, as the JAX
package does. Inside, an NHWC tensor viewed through ``.permute(0, 3, 1, 2)``
is a channels_last NCHW tensor, which ``F.conv2d`` takes without a copy.

Numerics follow the reference:
- convs run in the module's compute ``dtype`` (float32 accumulation); the
  folded bias and the activation follow in ``dtype``, BatchNorm (unfolded)
  and the activation after it in float32, and the result is cast to
  ``dtype``;
- explicit symmetric ``(k-1)//2 * dilation`` padding (torch convention);
- BatchNorm eps 1e-3, momentum ``bn_momentum`` in Flax's convention
  (default 0.99, torch's 0.01).

Train mode (``module.train()``) normalizes with the batch's float32 mean
and *biased* variance and updates the running statistics as Flax does,
``ra = m * ra + (1 - m) * batch`` with the biased variance
(:func:`batch_norm_train`). Under a ``torch.distributed`` process group the
batch is the global one: its statistics come from sums all-reduced over the
ranks, as the JAX package's mean over a data-sharded axis is a psum. Eval
mode reads the running statistics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.parallel import distributed

BN_EPS = 1e-3
BN_MOMENTUM = 0.99  # Flax's convention; torch's 0.01


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """Channel rounding rule used throughout the MobileNet family."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x+3)/6 — torch nn.Hardsigmoid."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x+3)/6 — torch nn.Hardswish."""
    return x * hard_sigmoid(x)


def _hardswish(x: torch.Tensor) -> torch.Tensor:
    """hardswish as torch's one fused op: x * min(max(x + 3, 0), 6) / 6,
    the arithmetic of the TPU kernel's _act and of the CUDA kernels. In
    float64 it is computed from its definition: torch's CUDA kernel takes
    1/6 as a float32 constant even there (3e-8 off the CPU's result)."""
    return hard_swish(x) if x.dtype == torch.float64 else F.hardswish(x)


ACTIVATIONS = {"relu": torch.relu, "hardswish": _hardswish, "silu": F.silu}


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW float32 ``x`` with Flax's statistics.

    ``F.batch_norm`` normalizes with the batch mean and biased variance but
    moves the running variance with the unbiased one, ``ra' = (1 - t) * ra
    + t * var * n / (n - 1)`` with ``t = bn.momentum``. Flax moves it with
    the biased one, which is ``a + (ra' - a) * (n - 1) / n`` with ``a = (1 -
    t) * ra``: that correction is made on the (C,) vectors, reading nothing
    back to the host. ``F.batch_norm`` is given copies of the buffers:
    autograd keeps the tensors it was given, which must not change before
    the backward.

    Under a process group the statistics are the global batch's
    (:func:`_batch_norm_global`)."""
    if distributed.is_active():
        return _batch_norm_global(x, bn)
    n = x.numel() // x.shape[1]
    t = bn.momentum
    mean, var = bn.running_mean.clone(), bn.running_var.clone()
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, t, bn.eps)
    with torch.no_grad():
        kept = (1.0 - t) * bn.running_var
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
    return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a process group (what
    ``nn.SyncBatchNorm`` computes, without its running-variance rule).

    Forward: the mean from the all-reduced per-channel sum and element
    count, then the biased variance from the all-reduced sum of squared
    deviations from it (two passes, so that no E[x^2] - E[x]^2 cancels).
    Backward: the closed form of the native BatchNorm backward, with its
    two per-channel sums (of dy and of dy * x_hat) all-reduced, so that
    every rank's activations receive the gradient of the statistics they
    share; the weight's and the bias's gradients are the rank's own, which
    DistributedDataParallel averages. Returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = (0, 2, 3)
        total = distributed.all_reduce_sum(
            torch.cat([x.sum(dims), x.new_full((1,), x.numel() // x.shape[1])]))
        n = total[-1]
        mean = total[:-1] / n
        d = x - mean[None, :, None, None]
        var = distributed.all_reduce_sum((d * d).sum(dims)) / n
        invstd = torch.rsqrt(var + eps)
        xhat = d * invstd[None, :, None, None]
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight[None, :, None, None] + bias[None, :, None, None], mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        xhat, weight, invstd, n = ctx.saved_tensors
        dims = (0, 2, 3)
        g_bias, g_weight = dy.sum(dims), (dy * xhat).sum(dims)
        sums = distributed.all_reduce_sum(torch.cat([g_bias, g_weight])) / n
        mean_dy, mean_dy_xhat = sums.chunk(2)
        dx = (weight * invstd)[None, :, None, None] * (
            dy - mean_dy[None, :, None, None] - xhat * mean_dy_xhat[None, :, None, None])
        return dx, g_weight, g_bias, None


def _batch_norm_global(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """:class:`_GlobalBatchNorm` of ``x`` in its dtype (float64 in a float64
    pass); the running statistics move by Flax's rule with the biased
    variance, as on one process (``nn.SyncBatchNorm`` would move them with
    the unbiased one)."""
    y, mean, var = _GlobalBatchNorm.apply(x, bn.weight.to(x.dtype), bn.bias.to(x.dtype), bn.eps)
    with torch.no_grad():
        t = bn.momentum
        bn.running_mean.mul_(1.0 - t).add_(t * mean.to(bn.running_mean.dtype))
        bn.running_var.mul_(1.0 - t).add_(t * var.to(bn.running_var.dtype))
    return y


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` on NCHW float32 whose train mode follows Flax
    (:func:`batch_norm_train`); eval mode reads the running statistics.
    Every BatchNorm of the port's models is one, so that
    ``training.loop.batch_norms`` finds them all."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return batch_norm_train(x, self)
        return super().forward(x)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view."""
    return x.permute(0, 2, 3, 1)


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm -> activation (the ``cbr`` unit). ``fold_bn=True``
    is the inference layout: no BN, the conv carries the folded bias."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 act: Optional[str] = "relu", use_bn: bool = True,
                 fold_bn: bool = False, bn_momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = (kernel - 1) // 2 * dilation
        self.act = act
        self.dtype = dtype
        self.conv = nn.Conv2d(
            in_features, features, kernel, stride=stride,
            padding=self.padding, dilation=dilation, groups=groups,
            bias=fold_bn and use_bn,
        )
        self.bn = (
            FlaxBatchNorm2d(features, eps=BN_EPS, momentum=1.0 - bn_momentum)
            if use_bn and not fold_bn else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The conv rounds its fp32 sum to ``dtype``, then the bias is added
        # in ``dtype`` (one more rounding), as a Flax conv with a bias does.
        # A bias fused into the conv is rounded at a backend-chosen point
        # (cuDNN: after the conv's own rounding; oneDNN: once), so it is
        # kept out, and the card and the CPU agree up to the order of the
        # conv's sum.
        y = F.conv2d(nchw(x.to(self.dtype)), self.conv.weight.to(self.dtype), None,
                     self.stride, self.padding, self.dilation, self.groups)
        if self.bn is not None:
            y = self.bn(y.float())
        elif self.conv.bias is not None:
            y = y + self.conv.bias.to(y.dtype)[:, None, None]
        if self.act is not None:
            y = ACTIVATIONS[self.act](y)
        return nhwc(y.to(self.dtype))


class SqueezeExcite(nn.Module):
    """global pool (fp32) -> 1x1 reduce (ReLU) -> 1x1 expand (hardsigmoid)
    -> channel gate. The pooled vector is cast to ``dtype`` before fc1."""

    def __init__(self, channels: int, squeeze_features: int,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Conv2d(channels, squeeze_features, 1, bias=True)
        self.fc2 = nn.Conv2d(squeeze_features, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # pooled in float32 (float64 in a float64 pass)
        s = x.mean(dim=(1, 2), dtype=torch.promote_types(x.dtype, torch.float32))
        s = s.to(self.dtype)  # (B, C)
        s = F.linear(s, self.fc1.weight.to(self.dtype).flatten(1),
                     self.fc1.bias.to(self.dtype))
        s = torch.relu(s)
        s = F.linear(s, self.fc2.weight.to(self.dtype).flatten(1),
                     self.fc2.bias.to(self.dtype))
        gate = hard_sigmoid(s.float()).to(x.dtype)
        return x * gate[:, None, None, :]


class InvertedResidual(nn.Module):
    """MobileNetV3 bottleneck: [1x1 expand] -> kxk depthwise -> [SE] -> 1x1
    project, residual (added in float32) when stride == 1 and in == out."""

    def __init__(self, in_features: int, expanded: int, out_features: int,
                 kernel: int, stride: int, dilation: int = 1,
                 use_se: bool = False, act: str = "relu", fold_bn: bool = False,
                 se_features: Optional[int] = None,
                 bn_momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        # dilation replaces striding in the dilated (LR-ASPP) tail
        self.stride = 1 if dilation > 1 else stride
        self.dilation, self.kernel, self.act = dilation, kernel, act
        self.in_features, self.expanded = in_features, expanded
        self.out_features = out_features
        self.dtype = dtype
        self.expand = (
            ConvBNAct(in_features, expanded, 1, act=act, fold_bn=fold_bn,
                      bn_momentum=bn_momentum, dtype=dtype)
            if expanded != in_features else None
        )
        self.depthwise = ConvBNAct(
            expanded, expanded, kernel, stride=self.stride, dilation=dilation,
            groups=expanded, act=act, fold_bn=fold_bn, bn_momentum=bn_momentum,
            dtype=dtype,
        )
        self.se = (
            SqueezeExcite(expanded, se_features or make_divisible(expanded // 4, 8),
                          dtype=dtype)
            if use_se else None
        )
        self.project = ConvBNAct(expanded, out_features, 1, act=None,
                                 fold_bn=fold_bn, bn_momentum=bn_momentum,
                                 dtype=dtype)

    @property
    def residual(self) -> bool:
        return self.stride == 1 and self.in_features == self.out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = self.depthwise(y)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        if self.residual:
            # one op: the sum is taken in float32 and rounded once
            y = (y + x).to(self.dtype)
        return y
