"""Weight bridge between the JAX package's Flax trees and the port's modules.

The Flax tree (``params`` and ``batch_stats`` of ``CardSegmentationModel``,
``HRNetPose`` or ``YOLO12Pose``, as nested dicts of numpy arrays) maps name for name onto the
port's ``state_dict``:

- conv kernels HWIO -> OIHW; that one permutation also turns a depthwise
  ``(k, k, 1, C)`` into ``(C, 1, k, k)`` and a 1x1 ``(1, 1, I, O)`` (SE,
  classifiers) into ``(O, I, 1, 1)``;
- transpose-conv kernels (``deconv*``): Flax keeps ``(kh, kw, in, out)`` and
  does not flip it; torch's ``ConvTranspose2d`` weight is ``(in, out, kh,
  kw)`` in the gradient form, i.e. spatially flipped, so the bridge flips
  both spatial axes and permutes;
- BN ``scale/bias`` -> ``weight/bias``, ``mean/var`` ->
  ``running_mean/running_var`` of ``BatchNorm2d(eps=1e-3)``.

``init_flax_like``, ``init_hrnet_flax_like`` and ``init_yolo_flax_like`` make
such trees from a numpy seed, for runs that have no trained checkpoint and no JAX (the card's
machine). ``init_flax_defaults`` gives a module Flax's default initial values
(a fresh training run); ``trainable_from_flax`` builds the segmentation model
for training from a tree.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetPose
from mtg_card_image_segmentation_tpu_torch.models.layers import make_divisible
from mtg_card_image_segmentation_tpu_torch.models.lraspp import CardSegmentationModel
from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import YOLO12Pose
from mtg_card_image_segmentation_tpu_torch.models.mobilenetv3 import (
    HIGH_CHANNELS,
    LOW_CHANNELS,
    MOBILENET_V3_LARGE_ROWS,
)

_STATS = {"mean": "running_mean", "var": "running_var"}


def _is_deconv(module_name: str) -> bool:
    """Is this Flax/torch module name a transpose conv (``deconv0``, not
    ``deconv_bn0``)?"""
    return module_name.startswith("deconv") and not module_name.startswith("deconv_bn")


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def flax_to_state_dict(params: Dict[str, Any],
                       batch_stats: Optional[Dict[str, Any]] = None) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``params`` (+ ``batch_stats``) -> torch ``state_dict`` names."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(p: Any, s: Any, path: Tuple[str, ...]) -> None:
        for key, val in p.items():
            sub = (s or {}).get(key) if isinstance(s, dict) else None
            if isinstance(val, dict):
                walk(val, sub, path + (key,))
                continue
            name = ".".join(path)
            t = _to_tensor(val)
            if key == "kernel" and _is_deconv(path[-1]):
                sd[f"{name}.weight"] = t.flip(0, 1).permute(2, 3, 0, 1).contiguous()
            elif key == "kernel":
                sd[f"{name}.weight"] = t.permute(3, 2, 0, 1).contiguous()
            elif key == "scale":
                sd[f"{name}.weight"] = t
            elif key == "bias":
                sd[f"{name}.bias"] = t
            else:
                raise KeyError(f"unknown Flax leaf {name}/{key}")
        if isinstance(s, dict) and "mean" in s:  # a BatchNorm's statistics
            name = ".".join(path)
            for k, tk in _STATS.items():
                sd[f"{name}.{tk}"] = _to_tensor(s[k])
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    walk(params, batch_stats, ())
    return sd


def state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of :func:`flax_to_state_dict`: (params, batch_stats) numpy
    trees in the Flax layout, float32 (float64 tensors stay float64). Every
    leaf is a copy: a float32 CPU tensor's ``.numpy()`` shares its memory,
    and a snapshot taken before an in-place update must not move with it
    (the JAX package's trees are immutable)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    inv_stats = {v: k for k, v in _STATS.items()}
    for name, t in sd.items():
        *path, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        a = t.detach()
        a = (a if a.dtype == torch.float64 else a.float()).cpu().numpy()
        if leaf in inv_stats:
            tree, key = stats, inv_stats[leaf]
        elif leaf == "weight" and a.ndim == 4 and _is_deconv(path[-1]):
            tree, key, a = params, "kernel", np.transpose(a, (2, 3, 0, 1))[::-1, ::-1]
        elif leaf == "weight" and a.ndim == 4:
            tree, key, a = params, "kernel", np.transpose(a, (2, 3, 1, 0))
        elif leaf == "weight":
            tree, key = params, "scale"
        else:
            tree, key = params, leaf
        for p in path:
            tree = tree.setdefault(p, {})
        tree[key] = np.array(a, order="C", copy=True)
    return params, stats


def expanded_widths(params: Dict[str, Any]):
    """Per-block expansion widths read from the tree (None = table value),
    so slim (channel-pruned) trees build the right module widths."""
    out = []
    for i, row in enumerate(MOBILENET_V3_LARGE_ROWS):
        c = int(np.shape(params["backbone"][f"block{i}"]["depthwise"]["conv"]["kernel"])[-1])
        out.append(None if c == row[1] else c)
    return tuple(out) if any(o is not None for o in out) else None


def from_flax(params: Dict[str, Any], batch_stats: Optional[Dict[str, Any]] = None,
              dtype: torch.dtype = torch.float32) -> CardSegmentationModel:
    """Build the port's ``CardSegmentationModel`` (eval mode, float32
    parameters, compute ``dtype``) from a Flax tree. A tree without
    ``batch_stats`` is taken as BN-folded (``fold_bn=True``)."""
    model = CardSegmentationModel(
        fold_bn=batch_stats is None,
        expanded_overrides=expanded_widths(params),
        dtype=dtype,
    )
    model.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)
    return model.eval()


def trainable_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        dtype: torch.dtype = torch.bfloat16) -> CardSegmentationModel:
    """Build the port's ``CardSegmentationModel`` for training from a Flax
    tree: train mode, BatchNorm unfolded (``batch_stats`` are required) with
    Flax's default momentum 0.99, float32 parameters, compute ``dtype``."""
    model = CardSegmentationModel(expanded_overrides=expanded_widths(params), dtype=dtype)
    model.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)
    return model.train()


@torch.no_grad()
def init_flax_defaults(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Give ``model`` (in place) the initial values of a Flax module with
    default initializers, drawn from a torch generator seeded with ``seed``:
    conv and transpose-conv kernels LeCun-normal truncated at two standard
    deviations (``variance_scaling(1, "fan_in", "truncated_normal")``),
    biases 0 (a module's ``bias_prior`` where it has one: the YOLO head's
    priors), BN scale 1 and bias 0, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    modules = dict(model.named_modules())
    for name, t in model.state_dict().items():
        module, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        prior = getattr(modules[module], "bias_prior", None)
        if leaf == "bias" and prior is not None:
            t.copy_(prior)
            continue
        if t.dim() == 4:
            # fan-in: OIHW convs I*kh*kw; (in, out, kh, kw) transpose convs
            # in*kh*kw, the Flax kernel's (kh, kw, in, out) read the same way
            deconv = _is_deconv(module.rsplit(".", 1)[-1])
            fan_in = t.shape[0] * t.shape[2] * t.shape[3] if deconv else t[0].numel()
            # the standard deviation of a unit normal truncated to [-2, 2]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            v = torch.empty(t.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std, generator=gen)
        elif leaf in ("weight", "running_var"):
            v = torch.ones(t.shape)
        else:
            v = torch.zeros(t.shape)
        t.copy_(v)
    return model


def hrnet_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                    heatmap_hw: Tuple[int, int] = (120, 160),
                    dtype: torch.dtype = torch.float32) -> HRNetPose:
    """Build the port's ``HRNetPose`` (eval mode, float32 parameters,
    compute ``dtype``) from a Flax tree; the number of keypoints is read
    from the tree."""
    model = HRNetPose(
        num_keypoints=int(np.shape(params["head"]["final"]["kernel"])[-1]),
        heatmap_height=heatmap_hw[0], heatmap_width=heatmap_hw[1], dtype=dtype,
    )
    model.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)
    return model.eval()


def init_hrnet_flax_like(seed: int, num_keypoints: int = 4) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) with the Flax layout and names of the JAX
    package's ``HRNetPose`` variables, drawn from a numpy seed.

    The names and shapes are read off the port's module; conv and
    transpose-conv kernels are LeCun-normal, BN scale, bias, mean and var
    are moved off their init values (1, 0, 0, 1), the final conv's bias is
    small and nonzero.
    """
    rng = np.random.default_rng(seed)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, t in HRNetPose(num_keypoints=num_keypoints).state_dict().items():
        module, leaf = name.rsplit(".", 1)
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            continue
        if t.dim() == 4:
            # fan-in: OIHW convs I*kh*kw; (in, out, kh, kw) transpose convs
            # in*kh*kw over the stride's 4 phases
            deconv = _is_deconv(module.rsplit(".", 1)[-1])
            fan_in = shape[0] * shape[2] * shape[3] / 4 if deconv else int(np.prod(shape[1:]))
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif leaf in ("weight", "running_var"):
            a = rng.uniform(0.8, 1.2, shape) if leaf == "weight" else rng.uniform(0.6, 1.4, shape)
        else:  # BN bias and mean, the final conv's bias
            a = 0.1 * rng.standard_normal(shape)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    return state_dict_to_flax(sd)


def yolo_from_flax(params: Dict[str, Any], batch_stats: Optional[Dict[str, Any]],
                   dtype: torch.dtype = torch.float32) -> YOLO12Pose:
    """Build the port's ``YOLO12Pose`` (eval mode, float32 parameters,
    compute ``dtype``) from a Flax tree; classes and keypoints are read from
    the tree (``kpt_dim`` is 3: x, y, confidence). A tree without
    ``batch_stats`` is taken as BN-folded (``fold_bn=True``,
    ``export/fold_bn.py``)."""
    net = params["net"]
    num_classes = int(np.shape(net["cls0_2"]["kernel"])[-1])
    model = YOLO12Pose(
        num_classes=num_classes,
        num_keypoints=int(np.shape(net["kpt0_2"]["kernel"])[-1]) // 3,
        kpt_dim=3, fold_bn=not batch_stats, dtype=dtype,
    )
    model.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)
    return model.eval()


def init_yolo_flax_like(seed: int, num_classes: int = 1,
                        num_keypoints: int = 4) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) with the Flax layout and names of the JAX
    package's ``YOLO12Pose`` variables, drawn from a numpy seed.

    Names and shapes are read off the port's module. Conv kernels are
    LeCun-normal, BN scale, bias, mean and var are moved off their init
    values (1, 0, 0, 1). The head's last biases follow the reference's
    priors: -4.595 (a 1% prior) on every class logit and on each keypoint's
    confidence channel, 0 on the keypoint offsets and the box bins.
    """
    rng = np.random.default_rng(seed)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    model = YOLO12Pose(num_classes=num_classes, num_keypoints=num_keypoints)
    modules = dict(model.named_modules())
    for name, t in model.state_dict().items():
        module, leaf = name.rsplit(".", 1)
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            continue
        prior = getattr(modules[module], "bias_prior", None)
        if t.dim() == 4:
            a = rng.standard_normal(shape) / np.sqrt(int(np.prod(shape[1:])))
        elif leaf == "bias" and prior is not None:  # the head's plain convs
            a = prior.numpy()
        elif leaf in ("weight", "running_var"):
            a = rng.uniform(0.8, 1.2, shape) if leaf == "weight" else rng.uniform(0.6, 1.4, shape)
        else:  # BN bias and mean
            a = 0.1 * rng.standard_normal(shape)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    return state_dict_to_flax(sd)


def init_flax_like(seed: int, num_classes: int = 2,
                   inter_channels: int = 128) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) with the Flax layout and names of the JAX
    package's ``CardSegmentationModel`` variables, drawn from a numpy seed.

    Conv kernels are LeCun-normal (Flax's default conv init); BN scale,
    bias, mean and var are moved off their init values (1, 0, 0, 1) so that
    folding is exercised; SE and classifier biases are small and nonzero.
    """
    rng = np.random.default_rng(seed)

    def kernel(k, cin, cout, groups=1):
        fan_in = k * k * cin // groups
        shape = (k, k, cin // groups, cout)
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def small(n, s=0.1):
        return (s * rng.standard_normal(n)).astype(np.float32)

    def cbr(k, cin, cout, groups=1):
        p = {"conv": {"kernel": kernel(k, cin, cout, groups)},
             "bn": {"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                    "bias": small(cout)}}
        s = {"bn": {"mean": small(cout),
                    "var": rng.uniform(0.6, 1.4, cout).astype(np.float32)}}
        return p, s

    params: Dict[str, Any] = {"backbone": {}, "head": {}}
    stats: Dict[str, Any] = {"backbone": {}, "head": {}}
    bb, bs = params["backbone"], stats["backbone"]
    bb["stem"], bs["stem"] = cbr(3, 3, 16)
    cin = 16
    for i, (k, exp, out, se, _act, _stride, _tail) in enumerate(MOBILENET_V3_LARGE_ROWS):
        p: Dict[str, Any] = {}
        s: Dict[str, Any] = {}
        if exp != cin:
            p["expand"], s["expand"] = cbr(1, cin, exp)
        p["depthwise"], s["depthwise"] = cbr(k, exp, exp, groups=exp)
        if se:
            sq = make_divisible(exp // 4, 8)
            p["se"] = {"fc1": {"kernel": kernel(1, exp, sq), "bias": small(sq)},
                       "fc2": {"kernel": kernel(1, sq, exp), "bias": small(exp)}}
        p["project"], s["project"] = cbr(1, exp, out)
        bb[f"block{i}"], bs[f"block{i}"] = p, s
        cin = out
    bb["head_conv"], bs["head_conv"] = cbr(1, cin, HIGH_CHANNELS)
    hd, hs = params["head"], stats["head"]
    hd["cbr"], hs["cbr"] = cbr(3, HIGH_CHANNELS, inter_channels)
    hd["scale"] = {"kernel": kernel(1, HIGH_CHANNELS, inter_channels)}
    hd["low_classifier"] = {"kernel": kernel(1, LOW_CHANNELS, num_classes),
                            "bias": small(num_classes)}
    hd["high_classifier"] = {"kernel": kernel(1, inter_channels, num_classes),
                             "bias": small(num_classes)}
    return params, stats


def count_parameters(params: Dict[str, Any]) -> int:
    """Total number of scalars in a Flax-layout param tree."""
    total = 0
    for v in params.values():
        total += count_parameters(v) if isinstance(v, dict) else int(np.prod(np.shape(v)))
    return total


def model_size_mb(variables) -> float:
    """Size of all variables in MB (1024^2 bytes): a module's parameters
    and its BatchNorm running statistics (``num_batches_tracked``, which the
    Flax tree lacks, is left out), or every leaf of a Flax-layout tree such
    as ``{"params": ..., "batch_stats": ...}`` (the JAX function's count)."""
    if isinstance(variables, torch.nn.Module):
        leaves = [p for p in variables.parameters()]
        leaves += [b for n, b in variables.named_buffers() if b.is_floating_point()]
        total = sum(t.numel() * t.element_size() for t in leaves)
    else:
        def walk(tree):
            for v in tree.values():
                yield from (walk(v) if isinstance(v, dict) else (np.asarray(v),))

        total = sum(a.size * a.itemsize for a in walk(variables))
    return total / 1024 / 1024
