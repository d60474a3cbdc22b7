"""int8 weight quantization (counterpart of the JAX package's
``export/quantize.py``). Two consumers:

- :func:`convert_to_int8`: fp32 ONNX graph -> QDQ form. Every Conv /
  ConvTranspose weight is replaced by a per-output-channel symmetric int8
  tensor + a DequantizeLinear node (the standard ONNX quantization format);
  compute stays fp32, and the file shrinks ~4x. ``export_seg_torch.py``
  gates it on mask agreement with the fp32 graph.
- :func:`quantize_params`: the same scheme on a folded param tree, for the
  serving predictor's int8 mode, which keeps the kernels on the card as
  int8 plus float32 scales and multiplies them out to dense weights in the
  compute dtype; compute stays in that dtype, so accuracy is governed by
  the weight rounding alone and a deployment is gated on mask agreement
  with the unquantized predictor.

Symmetric per output channel: ``scale_o = max|W[..., o]| / 127``,
``W_q = round(W / scale)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op


def _quantize_channelwise(w: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8: returns (w_int8, scales along ``axis``)."""
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.maximum(np.abs(w).max(axis=red), 1e-12)
    scale = (amax / 127.0).astype(np.float32)
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale


def convert_to_int8(model: op.Model) -> op.Model:
    """fp32 ONNX -> QDQ int8-weight ONNX (opset must be >= 13 for per-axis
    DequantizeLinear; the exporter emits 17)."""
    if model.opset < 13:
        raise ValueError(f"per-axis DequantizeLinear needs opset >= 13, got {model.opset}")
    # weight initializers consumed (only) as Conv/ConvTranspose input 1
    weight_users: Dict[str, list] = {}
    for n in model.nodes:
        for slot, i in enumerate(n.inputs):
            weight_users.setdefault(i, []).append((n.op_type, slot))

    inits, nodes = [], []
    for t in model.initializers:
        users = weight_users.get(t.name, [])
        is_conv_weight = (
            t.array.dtype == np.float32
            and t.array.ndim == 4
            and users
            and all(u == ("Conv", 1) or u == ("ConvTranspose", 1) for u in users)
        )
        if not is_conv_weight:
            inits.append(t)
            continue
        # Conv weights are OIHW (axis 0 = output channel); ConvTranspose are
        # IOHW (axis 1). Mixed consumption can't happen (name is unique).
        axis = 0 if users[0][0] == "Conv" else 1
        q, scale = _quantize_channelwise(t.array, axis)
        qname, sname = t.name + "_q", t.name + "_qscale"
        inits.append(op.Tensor(qname, q))
        inits.append(op.Tensor(sname, scale))
        nodes.append(
            op.Node(
                "DequantizeLinear", [qname, sname], [t.name],
                t.name + "_dq", {"axis": axis},
            )
        )
    return op.Model(
        model.graph_name, nodes + list(model.nodes), inits,
        list(model.inputs), list(model.outputs), model.opset,
        model.producer, model.doc,
    )


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
