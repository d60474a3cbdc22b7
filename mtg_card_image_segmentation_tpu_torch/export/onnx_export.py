"""Seg-model -> ONNX graph exporter.

Produces the reference's deployment contract (train/export.py:315-343,
demo/src/model-inference.js:12-17): input "input" (N,3,H,W) fp32
ImageNet-normalized NCHW, output "output" (N,num_classes,H,W) logits — so
the reference's ONNX-Runtime-Web browser demo is a drop-in consumer.

The graph is emitted from the *BN-folded* param tree (export/fold_bn.py):
Conv(+bias) / Relu / HardSigmoid / Mul / Add / Sigmoid / GlobalAveragePool /
Resize(linear, half_pixel) only — no BatchNormalization nodes, and
hardswish is decomposed as x*HardSigmoid(x) (torch opset-11/13 convention;
the demo notes the WebGL HardSigmoid gap and falls back to WASM,
demo/README.md:46-48).

The HRNet pose graph (``export_pose_model``) adds ConvTranspose and
nearest Resize (asymmetric coordinates, floor) to that op set.

The JAX package's ``export/onnx_export.py``, copied: the graph builder
(its layer helpers, and the tensor ops the YOLO graph of
``export/onnx_yolo.py`` uses), ``export_seg_model``, ``export_pose_model``,
``convert_to_fp16`` and ``auto_mixed_precision``. Given the same folded
numpy tree it writes the same bytes as the JAX writer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
from mtg_card_image_segmentation_tpu_torch.models.hrnet import (
    BOTTLENECK_EXPANSION,
    STAGE1_PLANES,
    W18_SMALL_BLOCKS,
    W18_SMALL_CHANNELS,
)
from mtg_card_image_segmentation_tpu_torch.models.mobilenetv3 import (
    LOW_TAP_ROW,
    MOBILENET_V3_LARGE_ROWS,
)


class GraphBuilder:
    def __init__(self) -> None:
        self.nodes: List[op.Node] = []
        self.initializers: List[op.Tensor] = []
        self._counter = 0

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def init_tensor(self, name: str, array: np.ndarray) -> str:
        self.initializers.append(op.Tensor(name, np.ascontiguousarray(array)))
        return name

    def node(self, op_type: str, inputs: List[str], hint: str, **attrs) -> str:
        out = self.fresh(hint)
        self.nodes.append(op.Node(op_type, inputs, [out], out, attrs))
        return out

    # -- layer helpers -----------------------------------------------------

    def conv(
        self, x: str, kernel_hwio: np.ndarray, bias: Optional[np.ndarray],
        hint: str, stride: int = 1, dilation: int = 1, groups: int = 1,
    ) -> str:
        k = kernel_hwio.shape[0]
        pad = (k - 1) // 2 * dilation
        w = self.init_tensor(
            self.fresh(hint + "_w"),
            np.transpose(kernel_hwio, (3, 2, 0, 1)).astype(kernel_hwio.dtype),
        )
        inputs = [x, w]
        if bias is not None:
            inputs.append(self.init_tensor(self.fresh(hint + "_b"), bias))
        return self.node(
            "Conv", inputs, hint,
            kernel_shape=[k, k], strides=[stride, stride],
            pads=[pad, pad, pad, pad], dilations=[dilation, dilation],
            group=groups,
        )

    def hardsigmoid(self, x: str, hint: str = "hsig") -> str:
        # torch hardsigmoid: relu6(x+3)/6 == HardSigmoid(alpha=1/6, beta=0.5)
        return self.node("HardSigmoid", [x], hint, alpha=1.0 / 6.0, beta=0.5)

    def hardswish(self, x: str, hint: str = "hswish") -> str:
        return self.node("Mul", [x, self.hardsigmoid(x, hint + "_hs")], hint)

    def act(self, x: str, act: Optional[str], hint: str) -> str:
        if act is None:
            return x
        if act == "relu":
            return self.node("Relu", [x], hint + "_relu")
        if act == "hardswish":
            return self.hardswish(x, hint + "_hswish")
        if act == "sigmoid":
            return self.node("Sigmoid", [x], hint + "_sig")
        raise ValueError(act)

    def _resize_inputs(self, x, n, c, h, w, hint, scale):
        """Resize size operands: static graphs pin full `sizes`; dynamic-
        batch graphs use the spatial `scales` input instead (a batch entry
        in `sizes` would re-pin the batch the dim_param just freed)."""
        if scale is None:
            sizes = self.init_tensor(
                self.fresh(hint + "_sizes"), np.asarray([n, c, h, w], np.int64)
            )
            return [x, "", "", sizes]
        scales = self.init_tensor(
            self.fresh(hint + "_scales"),
            np.asarray([1.0, 1.0, scale[0], scale[1]], np.float32),
        )
        return [x, "", scales]

    def resize_to(self, x: str, n: int, c: int, h: int, w: int, hint: str,
                  scale=None) -> str:
        return self.node(
            "Resize", self._resize_inputs(x, n, c, h, w, hint, scale), hint,
            mode="linear", coordinate_transformation_mode="half_pixel",
        )

    def resize_nearest_to(self, x: str, n: int, c: int, h: int, w: int,
                          hint: str, scale=None) -> str:
        """Nearest upsample, torch convention (src = floor(dst*in/out)):
        asymmetric + floor — exactly ops/resize.py nearest_resize."""
        return self.node(
            "Resize", self._resize_inputs(x, n, c, h, w, hint, scale), hint,
            mode="nearest", coordinate_transformation_mode="asymmetric",
            nearest_mode="floor",
        )

    def conv_transpose(
        self, x: str, kernel_hwio: np.ndarray, bias: Optional[np.ndarray],
        hint: str, stride: int = 2,
    ) -> str:
        """Emit ONNX ConvTranspose equivalent to flax ``nn.ConvTranspose``
        (padding='SAME', transpose_kernel=False, output = input*stride).

        Flax computes zero-insertion + *unflipped* correlation with the HWIO
        kernel and SAME pads pad_a = ceil((k+s-2)/2); ONNX ConvTranspose is
        zero-insertion + correlation with the spatially-flipped (I,O,kh,kw)
        weight at effective pads (k-1-p). Equality holds with
        W_onnx[i,o,kh,kw] = flip_hw(K)[kh,kw,i,o] and p = k-1-pad_a.
        """
        k = kernel_hwio.shape[0]
        pad_a = -(-(k + stride - 2) // 2)  # ceil
        p = k - 1 - pad_a
        if p < 0:
            raise ValueError(f"no ONNX padding for kernel {k}, stride {stride}")
        w = self.init_tensor(
            self.fresh(hint + "_w"),
            np.ascontiguousarray(
                np.transpose(np.flip(kernel_hwio, (0, 1)), (2, 3, 0, 1))
            ).astype(kernel_hwio.dtype),
        )
        inputs = [x, w]
        if bias is not None:
            inputs.append(self.init_tensor(self.fresh(hint + "_b"), bias))
        return self.node(
            "ConvTranspose", inputs, hint,
            kernel_shape=[k, k], strides=[stride, stride],
            pads=[p, p, p, p],
        )

    def global_avg_pool(self, x: str, hint: str = "gap") -> str:
        return self.node("GlobalAveragePool", [x], hint)

    # -- tensor ops (YOLO graph: attention / split / decode) ---------------

    def silu(self, x: str, hint: str = "silu") -> str:
        return self.node("Mul", [x, self.node("Sigmoid", [x], hint + "_sig")], hint)

    def reshape(self, x: str, shape, hint: str) -> str:
        shp = self.init_tensor(
            self.fresh(hint + "_shape"), np.asarray(shape, np.int64)
        )
        return self.node("Reshape", [x, shp], hint)

    def transpose(self, x: str, perm, hint: str) -> str:
        return self.node("Transpose", [x], hint, perm=[int(p) for p in perm])

    def matmul(self, a: str, b: str, hint: str) -> str:
        return self.node("MatMul", [a, b], hint)

    def slice(self, x: str, starts, ends, axes, hint: str) -> str:
        def mk(suffix, v):
            return self.init_tensor(self.fresh(hint + suffix), np.asarray(v, np.int64))

        return self.node(
            "Slice",
            [x, mk("_starts", starts), mk("_ends", ends), mk("_axes", axes)],
            hint,
        )

    def concat(self, xs: List[str], axis: int, hint: str) -> str:
        return self.node("Concat", xs, hint, axis=int(axis))

    def softmax(self, x: str, axis: int, hint: str) -> str:
        return self.node("Softmax", [x], hint, axis=int(axis))

    def const(self, array: np.ndarray, hint: str) -> str:
        return self.init_tensor(self.fresh(hint), np.asarray(array))


def _np(tree, *path):
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, np.float32)


def export_seg_model(
    folded_params: Dict,
    input_hw: Tuple[int, int] = (320, 240),
    num_classes: int = 2,
    inter_channels: int = 128,
    batch: int = 1,
    opset: int = 17,
    dynamic_batch: bool = False,
) -> op.Model:
    """Folded seg params (fold_bn=True layout) -> ONNX Model.

    ``dynamic_batch`` emits a symbolic batch axis (`dim_param` "N") on
    input/output and sizes the two upsamples via the Resize `scales`
    input, so one artifact serves any batch (the reference's
    `dynamic_axes`, train/export.py:68-79)."""
    h, w = input_hw
    g = GraphBuilder()
    bb = folded_params["backbone"]
    head = folded_params["head"]

    x = "input"
    # stem
    x = g.conv(x, _np(bb, "stem", "conv", "kernel"), _np(bb, "stem", "conv", "bias"),
               "stem", stride=2)
    x = g.act(x, "hardswish", "stem")

    in_ch = 16
    low_name = None
    for i, (k, exp, out_c, se, act, stride, in_tail) in enumerate(
        MOBILENET_V3_LARGE_ROWS
    ):
        blk = bb[f"block{i}"]
        dilation = 2 if in_tail else 1
        eff_stride = 1 if dilation > 1 else stride
        residual_src = x
        y = x
        # widths come from the params, not the arch table — a slimmed
        # (physically channel-pruned) checkpoint has narrower expansions
        if "expand" in blk:
            y = g.conv(y, _np(blk, "expand", "conv", "kernel"),
                       _np(blk, "expand", "conv", "bias"), f"b{i}_expand")
            y = g.act(y, act, f"b{i}_expand")
        exp_eff = int(np.asarray(blk["depthwise"]["conv"]["kernel"]).shape[-1])
        y = g.conv(y, _np(blk, "depthwise", "conv", "kernel"),
                   _np(blk, "depthwise", "conv", "bias"), f"b{i}_dw",
                   stride=eff_stride, dilation=dilation, groups=exp_eff)
        y = g.act(y, act, f"b{i}_dw")
        if se:
            s = g.global_avg_pool(y, f"b{i}_se_gap")
            s = g.conv(s, _np(blk, "se", "fc1", "kernel"), _np(blk, "se", "fc1", "bias"),
                       f"b{i}_se_fc1")
            s = g.node("Relu", [s], f"b{i}_se_relu")
            s = g.conv(s, _np(blk, "se", "fc2", "kernel"), _np(blk, "se", "fc2", "bias"),
                       f"b{i}_se_fc2")
            s = g.hardsigmoid(s, f"b{i}_se")
            y = g.node("Mul", [y, s], f"b{i}_se_mul")
        y = g.conv(y, _np(blk, "project", "conv", "kernel"),
                   _np(blk, "project", "conv", "bias"), f"b{i}_proj")
        if eff_stride == 1 and in_ch == out_c:
            y = g.node("Add", [y, residual_src], f"b{i}_res")
        x = y
        in_ch = out_c
        if i == LOW_TAP_ROW:
            low_name = x

    x = g.conv(x, _np(bb, "head_conv", "conv", "kernel"),
               _np(bb, "head_conv", "conv", "bias"), "head_conv")
    high = g.act(x, "hardswish", "head_conv")

    # LR-ASPP head (train/model.py:124-142 dataflow)
    cbr = g.conv(high, _np(head, "cbr", "conv", "kernel"),
                 _np(head, "cbr", "conv", "bias"), "cbr")
    cbr = g.node("Relu", [cbr], "cbr_relu")
    s = g.global_avg_pool(high, "scale_gap")
    s = g.conv(s, _np(head, "scale", "kernel"), None, "scale")
    s = g.node("Sigmoid", [s], "scale_sig")
    gated = g.node("Mul", [cbr, s], "gate")
    h8, w8 = h // 8, w // 8
    up = g.resize_to(gated, batch, inter_channels, h8, w8, "up_s8",
                     scale=(2.0, 2.0) if dynamic_batch else None)
    low_logits = g.conv(low_name, _np(head, "low_classifier", "kernel"),
                        _np(head, "low_classifier", "bias"), "low_cls")
    high_logits = g.conv(up, _np(head, "high_classifier", "kernel"),
                         _np(head, "high_classifier", "bias"), "high_cls")
    merged = g.node("Add", [low_logits, high_logits], "merge")
    out = g.resize_to(merged, batch, num_classes, h, w, "up_full",
                      scale=(8.0, 8.0) if dynamic_batch else None)
    # rename final node output to the contract name
    g.nodes[-1].outputs = ["output"]

    return op.Model(
        graph_name="card_segmentation",
        nodes=g.nodes,
        initializers=g.initializers,
        inputs=[("input", op.FLOAT,
                 (None if dynamic_batch else batch, 3, h, w))],
        outputs=[("output", op.FLOAT,
                  (None if dynamic_batch else batch, num_classes, h, w))],
        opset=opset,
        doc=(
            "LR-ASPP MobileNetV3-Large card segmentation, exported by "
            "mtg_card_image_segmentation_tpu (BN folded). Input: ImageNet-"
            "normalized NCHW fp32. Output: class logits (0=background, 1=card)."
        ),
    )


def export_pose_model(
    folded_params: Dict,
    input_hw: Tuple[int, int] = (480, 640),
    heatmap_hw: Tuple[int, int] = (120, 160),
    num_keypoints: int = 4,
    batch: int = 1,
    opset: int = 19,
    dynamic_batch: bool = False,
) -> op.Model:
    """Folded HRNet-pose params -> ONNX Model.

    ``dynamic_batch`` emits a symbolic batch axis and scales-based Resizes
    (the reference exports dynamic batch by default,
    train-pose-estimation_custom/export_onnx.py:74-95).

    Deployment contract of the custom pose pipeline
    (train-pose-estimation_custom/export_onnx.py:74-95): input "input"
    (N,3,H,W) fp32 scaled to [0,1] (/255 only — no ImageNet normalization,
    inference_test.py:167-169), output "heatmaps" (N,K,hm_h,hm_w). Opset 19
    matches the reference's export. The graph emission mirrors
    models/hrnet.py dataflow exactly (W18-small: stem s4, 1 bottleneck,
    3 stages growing branches (16,32),(16,32,64),(16,32,64,128), full
    cross-resolution fusion, deconv head).
    """
    h, w = input_hw
    g = GraphBuilder()
    bb = folded_params["backbone"]
    head = folded_params["head"]

    def cba(x, sub, hint, stride=1, act="relu", groups=1):
        y = g.conv(x, _np(sub, "conv", "kernel"), _np(sub, "conv", "bias"),
                   hint, stride=stride, groups=groups)
        return g.act(y, act, hint)

    def basic_block(x, sub, hint, in_ch, out_ch):
        y = cba(x, sub["conv1"], hint + "_c1")
        y = cba(y, sub["conv2"], hint + "_c2", act=None)
        if in_ch != out_ch:
            x = cba(x, sub["proj"], hint + "_proj", act=None)
        y = g.node("Add", [y, x], hint + "_add")
        return g.node("Relu", [y], hint + "_relu")

    def bottleneck(x, sub, hint, in_ch):
        out_ch = STAGE1_PLANES * BOTTLENECK_EXPANSION
        y = cba(x, sub["conv1"], hint + "_c1")
        y = cba(y, sub["conv2"], hint + "_c2")
        y = cba(y, sub["conv3"], hint + "_c3", act=None)
        if in_ch != out_ch:
            x = cba(x, sub["proj"], hint + "_proj", act=None)
        y = g.node("Add", [y, x], hint + "_add")
        return g.node("Relu", [y], hint + "_relu"), out_ch

    # stem: 2x stride-2 conv -> 64 @ s4
    x = cba("input", bb["stem1"], "stem1", stride=2)
    x = cba(x, bb["stem2"], "stem2", stride=2)
    x, ch = bottleneck(x, bb["stage1_block0"], "stage1", 64)

    # branch sizes at strides 4/8/16/32
    sizes = [(h // 4, w // 4), (h // 8, w // 8), (h // 16, w // 16), (h // 32, w // 32)]

    branches = [x]
    branch_ch = [ch]
    for stage_idx, channels in enumerate(W18_SMALL_CHANNELS):
        new_branches, new_ch = [], []
        for b, c in enumerate(channels):
            if b < len(branches):
                src = branches[b]
                if branch_ch[b] != c:
                    src = cba(src, bb[f"t{stage_idx}_b{b}"], f"t{stage_idx}_b{b}")
            else:
                src = cba(branches[-1], bb[f"t{stage_idx}_b{b}"],
                          f"t{stage_idx}_b{b}", stride=2)
            for blk in range(W18_SMALL_BLOCKS):
                src = basic_block(
                    src, bb[f"s{stage_idx}_b{b}_blk{blk}"],
                    f"s{stage_idx}_b{b}_blk{blk}", c, c,
                )
            new_branches.append(src)
            new_ch.append(c)
        # full cross-resolution fusion (models/hrnet.py FuseLayer)
        fuse = bb[f"fuse{stage_idx}"]
        fused = []
        for i, out_c in enumerate(channels):
            acc = None
            for j, src in enumerate(new_branches):
                if j == i:
                    y = src
                elif j < i:
                    y = src
                    for s in range(i - j):
                        last = s == i - j - 1
                        y = cba(y, fuse[f"down{i}_{j}_{s}"],
                                f"f{stage_idx}_d{i}_{j}_{s}", stride=2,
                                act=None if last else "relu")
                else:
                    y = cba(src, fuse[f"up{i}_{j}"], f"f{stage_idx}_u{i}_{j}",
                            act=None)
                    y = g.resize_nearest_to(
                        y, batch, out_c, *sizes[i], f"f{stage_idx}_u{i}_{j}_rs",
                        scale=(float(2 ** (j - i)),) * 2 if dynamic_batch
                        else None,
                    )
                acc = y if acc is None else g.node(
                    "Add", [acc, y], f"f{stage_idx}_o{i}_add{j}"
                )
            fused.append(g.node("Relu", [acc], f"f{stage_idx}_o{i}_relu"))
        branches, branch_ch = fused, list(channels)

    # head on the deepest branch (stride 32): 2x deconv, 2x 3x3 conv, 1x1
    x = branches[-1]
    for i in range(2):
        x = g.conv_transpose(
            x, _np(head, f"deconv{i}", "kernel"), _np(head, f"deconv{i}", "bias"),
            f"deconv{i}", stride=2,
        )
        x = g.node("Relu", [x], f"deconv{i}_relu")
    for i in range(2):
        x = cba(x, head[f"conv{i}"], f"head_conv{i}")
    x = g.conv(x, _np(head, "final", "kernel"), _np(head, "final", "bias"), "final")
    hm_h, hm_w = heatmap_hw
    g.resize_to(x, batch, num_keypoints, hm_h, hm_w, "up_hm",
                scale=(2.0, 2.0) if dynamic_batch else None)
    g.nodes[-1].outputs = ["heatmaps"]

    return op.Model(
        graph_name="card_corner_pose",
        nodes=g.nodes,
        initializers=g.initializers,
        inputs=[("input", op.FLOAT,
                 (None if dynamic_batch else batch, 3, h, w))],
        outputs=[("heatmaps", op.FLOAT,
                  (None if dynamic_batch else batch, num_keypoints,
                   hm_h, hm_w))],
        opset=opset,
        doc=(
            "HRNet-W18-small corner-keypoint heatmap model, exported by "
            "mtg_card_image_segmentation_tpu (BN folded). Input: NCHW fp32 "
            "in [0,1] (/255 only, no ImageNet normalization). Output: K "
            "corner heatmaps at heatmap resolution."
        ),
    )


def convert_to_fp16(
    model: op.Model,
    keep_io_types: bool = True,
    fp16_nodes: Optional[set] = None,
) -> op.Model:
    """fp32 -> fp16 conversion with fp32 I/O casts
    (onnx_fp16_converter.py:66-79 semantics: keep_io_types default).

    ``fp16_nodes``: names of the nodes to run in fp16 (None = all). Nodes
    outside the set stay fp32 and Cast ops are inserted at every
    fp16<->fp32 boundary — the mechanism behind mixed-precision export
    (auto_convert_mixed_precision, train-pose-estimation_custom/
    export_onnx.py:99-107). Initializers go fp16 iff every consumer is an
    fp16 node; non-float tensors (Resize sizes etc.) are never touched.
    """
    fp16set = (
        {n.name for n in model.nodes} if fp16_nodes is None else set(fp16_nodes)
    )
    # who consumes each value (for initializer dtype decisions)
    consumers: dict = {}
    for n in model.nodes:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n.name)

    # dtype category of every producible value: "f16" | "f32" | "other".
    # With keep_io_types=False the graph inputs are redeclared FLOAT16
    # below, so they must be tracked as f16 here — otherwise an fp32-kept
    # node consuming a graph input would get no Cast.
    cat: dict = {}
    for name, _elem, _shape in model.inputs:
        cat[name] = "f32" if keep_io_types else "f16"
    inits = []
    for t in model.initializers:
        if t.array.dtype == np.float32 and all(
            c in fp16set for c in consumers.get(t.name, [])
        ) and consumers.get(t.name):
            inits.append(op.Tensor(t.name, t.array.astype(np.float16)))
            cat[t.name] = "f16"
        else:
            inits.append(t)
            cat[t.name] = "f32" if t.array.dtype == np.float32 else "other"

    nodes: list = []
    cast_cache: dict = {}

    def casted(val: str, to16: bool) -> str:
        key = (val, to16)
        if key not in cast_cache:
            cname = val + ("_c16" if to16 else "_c32")
            nodes.append(
                op.Node(
                    "Cast", [val], [cname], cname,
                    {"to": op.FLOAT16 if to16 else op.FLOAT},
                )
            )
            cat[cname] = "f16" if to16 else "f32"
            cast_cache[key] = cname
        return cast_cache[key]

    for n in model.nodes:
        want = "f16" if n.name in fp16set else "f32"
        ins = []
        for i in n.inputs:
            c = cat.get(i, "other")
            if c in ("f16", "f32") and c != want:
                ins.append(casted(i, want == "f16"))
            else:
                ins.append(i)
        nodes.append(op.Node(n.op_type, ins, list(n.outputs), n.name, dict(n.attributes)))
        for o in n.outputs:
            cat[o] = want

    inputs = list(model.inputs)
    outputs = list(model.outputs)
    if keep_io_types:
        # graph outputs must stay fp32: re-route any fp16-produced output
        for name, _elem, _shape in outputs:
            if cat.get(name) == "f16":
                pre = name + "_fp16"
                for n in nodes:
                    n.outputs = [pre if o == name else o for o in n.outputs]
                    n.inputs = [pre if i == name else i for i in n.inputs]
                nodes.append(
                    op.Node("Cast", [pre], [name], name + "_cast", {"to": op.FLOAT})
                )
    else:
        inputs = [(n_, op.FLOAT16, s) for n_, _e, s in inputs]
        outputs = [(n_, op.FLOAT16, s) for n_, _e, s in outputs]
    return op.Model(
        model.graph_name, nodes, inits, inputs, outputs, model.opset,
        model.producer, model.doc,
    )


def auto_mixed_precision(
    model: op.Model,
    reference_output: np.ndarray,
    run_fn,
    rtol: float = 1e-2,
    atol: float = 1e-3,
    log=print,
):
    """Largest-fp16-prefix mixed-precision conversion, the behavioral twin
    of onnxconverter_common.auto_convert_mixed_precision
    (train-pose-estimation_custom/export_onnx.py:99-107): convert the graph
    to fp16 node-by-node in topological order, keeping a fp32 *suffix* just
    large enough that the converted model matches ``reference_output``
    within (rtol, atol). Binary-searches the boundary (error growth along
    the graph is monotone enough in practice; the final candidate is
    re-verified before returning).

    ``run_fn(model) -> np.ndarray`` executes a candidate model on the
    probe input. Returns (converted_model, n_fp16_nodes).
    """
    names = [n.name for n in model.nodes]

    def ok(k: int) -> Tuple[bool, op.Model]:
        cand = convert_to_fp16(model, keep_io_types=True, fp16_nodes=set(names[:k]))
        got = np.asarray(run_fn(cand))
        fine = bool(
            np.all(np.abs(got - reference_output) <= atol + rtol * np.abs(reference_output))
        )
        return fine, cand

    lo, hi = 0, len(names)  # lo = known-good fp16 prefix, hi+1.. = unknown
    fine, cand = ok(hi)
    if fine:
        log(f"auto-mixed-precision: all {hi} nodes fp16 within tolerance")
        return cand, hi
    best = None
    while lo < hi - 1:
        mid = (lo + hi) // 2
        fine, cand = ok(mid)
        log(f"auto-mixed-precision: fp16 prefix {mid}/{len(names)} "
            f"{'PASS' if fine else 'FAIL'}")
        if fine:
            lo, best = mid, cand
        else:
            hi = mid
    if best is None:
        fine, best = ok(lo)  # lo == 0: pure fp32 with IO casts
        if not fine:
            # even the fp32 graph misses tolerance: bad probe/run_fn, not a
            # precision boundary — surfacing beats returning a failing model
            raise ValueError(
                "auto_mixed_precision: fp32 baseline outside tolerance — "
                "reference_output/run_fn disagree independent of precision"
            )
    log(f"auto-mixed-precision: keeping {len(names) - lo} trailing nodes fp32")
    return best, lo
