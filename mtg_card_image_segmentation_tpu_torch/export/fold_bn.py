"""BatchNorm folding on Flax-layout trees (copy of the JAX package's
``export/fold_bn.py`` for numpy or torch leaves).

For every ConvBNAct subtree {"conv": {kernel[, bias]}, "bn": {scale, bias}}
with running stats {"bn": {mean, var}}:

    g = scale / sqrt(var + eps)            (per output channel)
    kernel' = kernel * g                    (broadcast over HWIO -> O)
    bias'   = bn_bias - mean * g  [+ conv_bias * g]

The HRNet head's transpose-conv pairs (``deconvN`` + ``deconv_bnN``, the
kernel (kh, kw, in, out)) fold the same way.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

BN_EPS = 1e-3


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else np.sqrt(x)


def _fold_one(conv: Dict[str, Any], bn_params: Dict[str, Any], bn_stats: Dict[str, Any]):
    g = bn_params["scale"] / _sqrt(bn_stats["var"] + BN_EPS)
    kernel = conv["kernel"] * g  # HWIO * (O,)
    bias = bn_params["bias"] - bn_stats["mean"] * g
    if "bias" in conv:
        bias = bias + conv["bias"] * g
    return {"kernel": kernel, "bias": bias}


def fold_batch_norm(params: Dict[str, Any], batch_stats: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively fold every sibling (conv, bn) pair and every (deconvN,
    deconv_bnN) pair. Returns a new tree for the ``fold_bn=True`` model (bn
    subtrees removed, conv and deconv gain a bias)."""

    def rec(p: Any, s: Any) -> Any:
        if not isinstance(p, dict):
            return p
        stats = s if isinstance(s, dict) else {}
        out: Dict[str, Any] = {}
        if "conv" in p and isinstance(p.get("bn"), dict):
            out["conv"] = _fold_one(p["conv"], p["bn"], stats.get("bn", {}))
        for key in p:
            if key in out or (key == "bn" and "conv" in out) or key.startswith("deconv_bn"):
                continue
            bn_key = "deconv_bn" + key[len("deconv"):]
            if key.startswith("deconv") and bn_key in p:
                out[key] = _fold_one(p[key], p[bn_key], stats.get(bn_key, {}))
            else:
                out[key] = rec(p[key], stats.get(key))
        return out

    return rec(params, batch_stats)
