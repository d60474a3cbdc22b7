"""int8 weight quantization of a folded param tree (the parameter half of
the JAX package's ``export/quantize.py``; the ONNX QDQ conversion is not
part of the port yet).

Symmetric per output channel: ``scale_o = max|W[..., o]| / 127``,
``W_q = round(W / scale)``. The serving predictor's int8 mode keeps the
kernels on the card as int8 plus float32 scales and multiplies them out to
dense weights in the compute dtype; compute stays in that dtype, so accuracy
is governed by the weight rounding alone and a deployment is gated on mask
agreement with the unquantized predictor.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _quantize_channelwise(w: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8: returns (w_int8, scales along ``axis``)."""
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.maximum(np.abs(w).max(axis=red), 1e-12)
    scale = (amax / 127.0).astype(np.float32)
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale


def quantize_params(folded: Dict, min_size: int = 512) -> Dict:
    """Folded Flax-layout param tree -> the same tree with every conv kernel
    of >= ``min_size`` elements replaced by {"kernel_q": int8,
    "kernel_scale": (O,) float32} (HWIO, per output channel). Small kernels
    (the stem, the 1x1 classifiers) and biases stay float32."""

    def rec(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if (
                k == "kernel"
                and hasattr(v, "ndim")
                and v.ndim == 4
                and int(np.prod(v.shape)) >= min_size
            ):
                q, scale = _quantize_channelwise(np.asarray(v, np.float32), 3)
                out["kernel_q"] = q
                out["kernel_scale"] = scale
            else:
                out[k] = rec(v)
        return out

    return rec(folded)


class _TorchXP:
    """The two numpy names ``dequantize_params`` uses, on torch tensors, so
    that the multiply runs where the int8 tensors live (the card)."""

    float32 = torch.float32

    @staticmethod
    def asarray(v, dtype):
        return torch.as_tensor(v).to(dtype)


torch_xp = _TorchXP()


def dequantize_params(tree: Dict, dtype=np.float32, xp=np) -> Dict:
    """Inverse of :func:`quantize_params`: dense kernels
    ``float32(kernel_q) * kernel_scale`` cast to ``dtype``.

    ``xp=np`` on the host with a numpy ``dtype``; ``xp=torch_xp`` with a
    torch ``dtype`` for int8 tensors that live on a device."""

    def cast(a):
        return a.astype(dtype) if xp is np else a.to(dtype)

    def rec(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "kernel_q":
                out["kernel"] = cast(xp.asarray(v, xp.float32) * node["kernel_scale"])
            elif k == "kernel_scale":
                continue
            else:
                out[k] = rec(v)
        return out

    return rec(tree)
