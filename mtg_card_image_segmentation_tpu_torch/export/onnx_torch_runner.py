"""Torch ONNX executor: the port's runner for every export parity gate
(counterpart of the JAX package's ``export/onnx_torch_runner.py``, with a
device).

It re-interprets every node of a parsed graph (``onnx_proto.Model``) with
torch ops (F.conv2d / F.interpolate / F.hardsigmoid ...), whose padding,
stride, dilation and resize semantics come from a codebase unrelated to the
writer, so agreement of the torch model and this executor within the fp32
gate is evidence that the .onnx file means what ONNX says it means.

``device=None`` runs on the CUDA card (``utils.platform.resolve_device``);
the CPU must be asked for with ``device="cpu"``. Initializers move to the
device once, in :func:`make_runner`; each call moves its feeds there and
returns numpy. Nodes run eagerly, one after another. The op set is that
of the segmentation, HRNet pose (ConvTranspose, nearest Resize) and YOLO
graphs (Concat, MatMul, Reshape, Slice, Softmax, Sub, Transpose).

Two differences from the JAX package's copy, which runs fp32 torch on the
host:

- fp16 is real. A ``Cast`` to FLOAT16 yields float16 tensors, and fp16
  initializers stay float16, so the fp16 graph's convs run in float16
  (cuDNN on the card), as a deployment runtime runs them; the JAX
  package's mini runtime keeps fp16 too. Gate such graphs in probability
  space (``export_seg_torch.py``).
- fp32 is only fp32 where TF32 is off: cuDNN's convolutions default to TF32
  on the H100, which breaks the 1e-4 fp32 gate; and with TF32 off they
  still round several times more than the host over long reductions.
  Callers that gate float32 graphs run the executor inside
  ``utils.platform.ieee_fp32()`` (TF32 and cuDNN off).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
from mtg_card_image_segmentation_tpu_torch.ops.resize import nearest_indices
from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

_CAST = {op.FLOAT: torch.float32, op.FLOAT16: torch.float16,
         op.INT64: torch.int64, op.INT32: torch.int32}


def make_runner(model: op.Model, device=None,
                dtype: Optional[torch.dtype] = None) -> Callable[[Dict[str, np.ndarray]],
                                                                 Dict[str, np.ndarray]]:
    """``run(feeds) -> {output name: numpy array}`` for ``model``, with its
    initializers moved to ``device`` once. ``dtype=torch.float64`` runs a
    float32 graph in float64: its float32 initializers and feeds are
    widened, so the run computes the function that the file's weights
    define, with float64 rounding (a graph with a Cast refuses)."""
    dev = resolve_device(device)
    if dtype is not None and any(n.op_type == "Cast" for n in model.nodes):
        raise NotImplementedError("a graph with Cast nodes runs in its own types")
    # the Resize size operands are read on the host
    host = {t.name: t.array for t in model.initializers}
    weights = {name: _widen(torch.from_numpy(np.ascontiguousarray(a).copy()), dtype).to(dev)
               for name, a in host.items()}
    out_names = [name for name, _, _ in model.outputs]

    @torch.inference_mode()
    def run(feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        env: Dict[str, torch.Tensor] = dict(weights)
        for name, value in feeds.items():
            env[name] = _widen(torch.from_numpy(np.ascontiguousarray(value)), dtype).to(dev)
        for node in model.nodes:
            env[node.outputs[0]] = _run_node(node, env, host)
        return {name: env[name].cpu().numpy() for name in out_names}

    return run


def _widen(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t.to(dtype) if dtype is not None and t.dtype == torch.float32 else t


def run_model(model: op.Model, feeds: Dict[str, np.ndarray],
              device=None) -> Dict[str, np.ndarray]:
    """One run of ``model`` on ``feeds`` (numpy): :func:`make_runner`'s
    runner, called once."""
    return make_runner(model, device)(feeds)


def _run_node(node: op.Node, env: Dict[str, torch.Tensor],
              host: Dict[str, np.ndarray]) -> torch.Tensor:
    ins = [env[i] if i else None for i in node.inputs]
    a = node.attributes
    t = node.op_type
    if t in ("Conv", "ConvTranspose"):
        pads = a.get("pads", [0, 0, 0, 0])
        if pads[0] != pads[2] or pads[1] != pads[3]:
            raise NotImplementedError(f"asymmetric pads {pads}")
        x = ins[0]
        if x.is_cuda and x.dtype == torch.float16:
            # cuDNN's NCHW float16 depthwise kernel returns wrong values on
            # the H100 (torch 2.11, cuDNN 9.2: a 3x3 depthwise over 200
            # channels of 20x15 off by as much as its outputs); its
            # channels_last kernels, which the port's serving path uses,
            # are right. Transpose convs take the same layout.
            x = x.contiguous(memory_format=torch.channels_last)
        bias = ins[2] if len(ins) > 2 else None
        stride = tuple(a.get("strides", [1, 1]))
        if t == "ConvTranspose":
            return F.conv_transpose2d(x, ins[1], bias, stride=stride,
                                      padding=(pads[0], pads[1]))
        return F.conv2d(
            x, ins[1], bias, stride=stride,
            padding=(pads[0], pads[1]),
            dilation=tuple(a.get("dilations", [1, 1])),
            groups=int(a.get("group", 1)),
        )
    if t == "Relu":
        return F.relu(ins[0])
    if t == "Sigmoid":
        return torch.sigmoid(ins[0])
    if t == "HardSigmoid":
        alpha = a.get("alpha", 0.2)
        beta = a.get("beta", 0.5)
        if (ins[0].dtype != torch.float64
                and abs(alpha - 1.0 / 6.0) < 1e-6 and abs(beta - 0.5) < 1e-6):
            return F.hardsigmoid(ins[0])  # torch's own kernel
        # the ONNX definition with the file's alpha and beta (in float64:
        # torch's CUDA kernel takes 1/6 as a float32 constant even there)
        return torch.clamp(ins[0] * alpha + beta, 0.0, 1.0)
    if t == "Mul":
        return ins[0] * ins[1]
    if t == "Add":
        return ins[0] + ins[1]
    if t == "Sub":
        return ins[0] - ins[1]
    if t == "MatMul":
        return torch.matmul(ins[0], ins[1])
    if t == "Softmax":
        return torch.softmax(ins[0], dim=int(a.get("axis", -1)))
    if t == "Concat":
        return torch.cat(ins, dim=int(a.get("axis", 1)))
    if t == "Transpose":
        return ins[0].permute(*(int(p) for p in a["perm"]))
    if t == "Reshape":
        # the shape operand is read on the host; no 0 (copy) entries are
        # emitted, -1 is inferred as ONNX infers it
        return ins[0].reshape(tuple(int(d) for d in host[node.inputs[1]]))
    if t == "Slice":
        x = ins[0]
        idx = [slice(None)] * x.dim()
        for s, e, ax in zip(*(host[name] for name in node.inputs[1:4])):
            dim = x.shape[int(ax)]
            idx[int(ax)] = slice(int(np.clip(s, -dim, dim)), int(np.clip(e, -dim, dim)))
        return x[tuple(idx)]
    if t == "GlobalAveragePool":
        return F.adaptive_avg_pool2d(ins[0], 1)
    if t == "Resize":
        if len(node.inputs) > 3 and node.inputs[3]:
            sizes = host[node.inputs[3]]
            size = (int(sizes[2]), int(sizes[3]))
        else:
            # dynamic-batch graphs use the `scales` input
            # (ONNX: out = floor(in * scale))
            scales = host[node.inputs[2]]
            size = (int(math.floor(ins[0].shape[2] * float(scales[2]))),
                    int(math.floor(ins[0].shape[3] * float(scales[3]))))
        mode = a.get("mode", "linear")
        ctm = a.get("coordinate_transformation_mode", "half_pixel")
        if mode == "linear" and ctm == "half_pixel":
            return F.interpolate(ins[0], size=size, mode="bilinear", align_corners=False)
        if (mode == "nearest" and ctm == "asymmetric"
                and a.get("nearest_mode", "round_prefer_floor") == "floor"):
            # the exporter's convention, src = floor(dst * in / out), as
            # ops/resize.py::nearest_resize gathers it
            x = ins[0]
            rows = torch.from_numpy(nearest_indices(x.shape[2], size[0])).to(x.device)
            cols = torch.from_numpy(nearest_indices(x.shape[3], size[1])).to(x.device)
            return x.index_select(2, rows).index_select(3, cols)
        raise NotImplementedError(
            f"Resize mode={mode} ctm={ctm} nearest_mode={a.get('nearest_mode')}")
    if t == "Cast":
        return ins[0].to(_CAST[int(a["to"])])
    if t == "DequantizeLinear":
        axis = int(a.get("axis", 1))
        shape = [1] * ins[0].ndim
        shape[axis] = -1
        zp = ins[2].to(torch.float32) if len(ins) > 2 and ins[2] is not None else 0.0
        return (ins[0].to(torch.float32) - zp) * ins[1].reshape(shape)
    raise NotImplementedError(f"op {t}")
