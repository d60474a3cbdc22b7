"""YOLO12n-pose -> ONNX graph exporter (copy of the JAX package's
``export/onnx_yolo.py``; given the same folded numpy tree it writes the same
bytes as the JAX writer).

The reference exports its YOLO family via ultralytics ``.export(
format='onnx', opset 11, simplify, dynamic, half)``
(train-pose-estimation_yolo12n/model.py:266-310). Here the graph is emitted
directly from the BN-folded param tree (export/fold_bn.py), mirroring
models/yolo12_pose.py dataflow node for node — backbone/PAN (C3k2, A2C2f
area attention), the Detect+Pose heads, and the full in-graph decode (DFL
softmax expectation -> pixel xyxy boxes, sigmoid scores, corner-heatmap
keypoint decode).

Output contract (single tensor, ultralytics-style pre-NMS layout):
  "output0": (batch, 4 + 1 + K*3, A) fp32 — rows are
  [x1, y1, x2, y2, score, (kx, ky, kconf) x K] in input-pixel space,
  A = sum over P3/P4/P5 of (H/s * W/s). The consumer applies max_det=1
  selection with the joint corner decode of export/yolo_client_decode.py.

Op set: Conv / Sigmoid / Mul / Add / Sub / Concat / Slice / Reshape /
Transpose / MatMul / Softmax / Resize(nearest) — all executed by the port's
torch executor (export/onnx_torch_runner.py) and by ONNX Runtime.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
from mtg_card_image_segmentation_tpu_torch.export.onnx_export import GraphBuilder, _np
from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import (
    KPT_OFFSET_SCALE,
    REG_MAX,
    STRIDES,
)


def export_yolo_model(
    folded_params: Dict,
    imgsz: int = 640,
    num_classes: int = 1,
    num_keypoints: int = 4,
    batch: int = 1,
    opset: int = 19,
    dynamic_batch: bool = False,
) -> op.Model:
    """Folded yolo12n-pose params (fold_bn=True layout) -> ONNX Model.

    ``dynamic_batch`` emits a symbolic batch axis (the reference's
    ultralytics export defaults ``dynamic=True``, model.py:266-310): the
    attention/decode reshapes keep a ``-1`` leading batch dim, PAN
    upsamples use the Resize ``scales`` input, and MatMuls broadcast over
    the extra leading dims (ONNX stacked-matmul semantics)."""
    if imgsz % 32:
        raise ValueError(f"imgsz {imgsz} is not a multiple of 32")
    nb = -1 if dynamic_batch else batch  # leading dim for batch-carrying reshapes
    g = GraphBuilder()
    net = folded_params["net"]

    def cbs(x, sub, hint, stride=1, groups=1, act=True):
        y = g.conv(x, _np(sub, "conv", "kernel"), _np(sub, "conv", "bias"),
                   hint, stride=stride, groups=groups)
        return g.silu(y, hint + "_silu") if act else y

    def out_ch(sub) -> int:
        return int(np.asarray(sub["conv"]["kernel"]).shape[-1])

    def bottleneck(x, sub, hint, in_ch):
        y = cbs(x, sub["cv1"], hint + "_cv1")
        y = cbs(y, sub["cv2"], hint + "_cv2")
        if in_ch == out_ch(sub["cv2"]):
            y = g.node("Add", [y, x], hint + "_res")
        return y

    def c3k(x, sub, hint):
        c_ = out_ch(sub["cv1"])
        a = cbs(x, sub["cv1"], hint + "_cv1")
        b = cbs(x, sub["cv2"], hint + "_cv2")
        i = 0
        while f"m{i}" in sub:
            a = bottleneck(a, sub[f"m{i}"], f"{hint}_m{i}", c_)
            i += 1
        return cbs(g.concat([a, b], 1, hint + "_cat"), sub["cv3"], hint + "_cv3")

    def c3k2(x, sub, hint, use_c3k):
        c = out_ch(sub["cv1"]) // 2
        y = cbs(x, sub["cv1"], hint + "_cv1")
        ys = [
            g.slice(y, [0], [c], [1], hint + "_s0"),
            g.slice(y, [c], [2 * c], [1], hint + "_s1"),
        ]
        i = 0
        while f"m{i}" in sub:
            if use_c3k:
                ys.append(c3k(ys[-1], sub[f"m{i}"], f"{hint}_m{i}"))
            else:
                ys.append(bottleneck(ys[-1], sub[f"m{i}"], f"{hint}_m{i}", c))
            i += 1
        return cbs(g.concat(ys, 1, hint + "_cat"), sub["cv2"], hint + "_cv2")

    def aattn(x, sub, hint, dim, h, w, area):
        heads = max(1, dim // 32)
        hd = dim // heads
        n = h * w
        if n % area:
            raise ValueError(f"{h}x{w} tokens not divisible by area {area}")
        m = n // area
        qkv = cbs(x, sub["qkv"], hint + "_qkv", act=False)  # (N, 3C, H, W)
        if dynamic_batch:
            # keep N as a -1 leading dim; MatMul broadcasts leading dims
            t = g.reshape(qkv, (nb, 3, heads, hd, area, m), hint + "_split")
            q = g.slice(t, [0], [1], [1], hint + "_q")
            k = g.slice(t, [1], [2], [1], hint + "_k")
            v = g.slice(t, [2], [3], [1], hint + "_v")
            q4 = g.reshape(q, (nb, heads, hd, area, m), hint + "_q4")
            k4 = g.reshape(k, (nb, heads, hd, area, m), hint + "_k4")
            v4 = g.reshape(v, (nb, heads, hd, area, m), hint + "_v4")
            qT = g.transpose(q4, (0, 3, 1, 4, 2), hint + "_qT")  # (N,area,heads,m,hd)
            kT = g.transpose(k4, (0, 3, 1, 2, 4), hint + "_kT")  # (N,area,heads,hd,m)
            vT = g.transpose(v4, (0, 3, 1, 4, 2), hint + "_vT")  # (N,area,heads,m,hd)
        else:
            t = g.reshape(qkv, (3, heads, hd, area, m), hint + "_split")
            q = g.slice(t, [0], [1], [0], hint + "_q")
            k = g.slice(t, [1], [2], [0], hint + "_k")
            v = g.slice(t, [2], [3], [0], hint + "_v")
            q4 = g.reshape(q, (heads, hd, area, m), hint + "_q4")
            k4 = g.reshape(k, (heads, hd, area, m), hint + "_k4")
            v4 = g.reshape(v, (heads, hd, area, m), hint + "_v4")
            qT = g.transpose(q4, (2, 0, 3, 1), hint + "_qT")  # (area, heads, m, hd)
            kT = g.transpose(k4, (2, 0, 1, 3), hint + "_kT")  # (area, heads, hd, m)
            vT = g.transpose(v4, (2, 0, 3, 1), hint + "_vT")  # (area, heads, m, hd)
        attn = g.matmul(qT, kT, hint + "_logits")
        scale = g.const(np.asarray(hd**-0.5, np.float32), hint + "_scale")
        attn = g.node("Mul", [attn, scale], hint + "_scaled")
        attn = g.softmax(attn, -1, hint + "_sm")
        o = g.matmul(attn, vT, hint + "_av")  # (..., m, hd)
        if dynamic_batch:
            o = g.transpose(o, (0, 2, 4, 1, 3), hint + "_oT")  # (N,heads,hd,area,m)
        else:
            o = g.transpose(o, (1, 3, 0, 2), hint + "_oT")  # (heads, hd, area, m)
        o = g.reshape(o, (nb, dim, h, w), hint + "_o")
        vv = g.reshape(v4, (nb, dim, h, w), hint + "_vv")
        pe = cbs(vv, sub["pe"], hint + "_pe", groups=dim, act=False)
        o = g.node("Add", [o, pe], hint + "_ope")
        return cbs(o, sub["proj"], hint + "_proj", act=False)

    def ablock(x, sub, hint, dim, h, w, area):
        y = aattn(x, sub["attn"], hint + "_attn", dim, h, w, area)
        x = g.node("Add", [x, y], hint + "_res1")
        y = cbs(x, sub["mlp1"], hint + "_mlp1")
        y = cbs(y, sub["mlp2"], hint + "_mlp2", act=False)
        return g.node("Add", [x, y], hint + "_res2")

    def a2c2f(x, sub, hint, h=None, w=None, area=1):
        c_ = out_ch(sub["cv1"])
        y = cbs(x, sub["cv1"], hint + "_cv1")
        ys = [y]
        i = 0
        while f"m{i}" in sub or f"m{i}_0" in sub:
            z = ys[-1]
            if f"m{i}_0" in sub:  # attention variant
                for j in range(2):
                    z = ablock(z, sub[f"m{i}_{j}"], f"{hint}_m{i}_{j}",
                               c_, h, w, area)
            else:  # C3k variant
                z = c3k(z, sub[f"m{i}"], f"{hint}_m{i}")
            ys.append(z)
            i += 1
        return cbs(g.concat(ys, 1, hint + "_cat"), sub["cv2"], hint + "_cv2")

    s8, s16, s32 = imgsz // 8, imgsz // 16, imgsz // 32

    # --- backbone (models/yolo12_pose.py:252-263) ---
    x = cbs("input", net["l0"], "l0", stride=2)
    x = cbs(x, net["l1"], "l1", stride=2)
    x = c3k2(x, net["l2"], "l2", use_c3k=False)
    x = cbs(x, net["l3"], "l3", stride=2)
    p3_bb = c3k2(x, net["l4"], "l4", use_c3k=False)
    x = cbs(p3_bb, net["l5"], "l5", stride=2)
    p4_bb = a2c2f(x, net["l6"], "l6", h=s16, w=s16, area=4)
    x = cbs(p4_bb, net["l7"], "l7", stride=2)
    p5_bb = a2c2f(x, net["l8"], "l8", h=s32, w=s32, area=1)

    # --- PAN head (rows 9-20) ---
    ch_p4bb = out_ch(net["l6"]["cv2"])
    ch_p5bb = out_ch(net["l8"]["cv2"])
    up = g.resize_nearest_to(p5_bb, batch, ch_p5bb, s16, s16, "up_p5",
                             scale=(2.0, 2.0) if dynamic_batch else None)
    x = g.concat([up, p4_bb], 1, "cat_p4")
    p4_mid = a2c2f(x, net["l11"], "l11")
    ch_p4mid = out_ch(net["l11"]["cv2"])
    up = g.resize_nearest_to(p4_mid, batch, ch_p4mid, s8, s8, "up_p4",
                             scale=(2.0, 2.0) if dynamic_batch else None)
    x = g.concat([up, p3_bb], 1, "cat_p3")
    p3 = a2c2f(x, net["l14"], "l14")
    x = cbs(p3, net["l15"], "l15", stride=2)
    x = g.concat([x, p4_mid], 1, "cat_p4b")
    p4 = a2c2f(x, net["l17"], "l17")
    x = cbs(p4, net["l18"], "l18", stride=2)
    x = g.concat([x, p5_bb], 1, "cat_p5b")
    p5 = c3k2(x, net["l20"], "l20", use_c3k=True)

    # --- Detect+Pose heads + in-graph decode per level ---
    level_outs: List[str] = []
    for li, (feat, hw) in enumerate(zip((p3, p4, p5), (s8, s16, s32))):
        stride = STRIDES[li]
        b = cbs(feat, net[f"box{li}_0"], f"box{li}_0")
        b = cbs(b, net[f"box{li}_1"], f"box{li}_1")
        b = g.conv(b, _np(net, f"box{li}_2", "kernel"),
                   _np(net, f"box{li}_2", "bias"), f"box{li}_2")
        feat_ch = int(np.asarray(net[f"cls{li}_0dw"]["conv"]["kernel"]).shape[-1])
        c = cbs(feat, net[f"cls{li}_0dw"], f"cls{li}_0dw", groups=feat_ch)
        c = cbs(c, net[f"cls{li}_0pw"], f"cls{li}_0pw")
        c3ch = out_ch(net[f"cls{li}_0pw"])
        c = cbs(c, net[f"cls{li}_1dw"], f"cls{li}_1dw", groups=c3ch)
        c = cbs(c, net[f"cls{li}_1pw"], f"cls{li}_1pw")
        c = g.conv(c, _np(net, f"cls{li}_2", "kernel"),
                   _np(net, f"cls{li}_2", "bias"), f"cls{li}_2")
        k = cbs(feat, net[f"kpt{li}_0"], f"kpt{li}_0")
        k = cbs(k, net[f"kpt{li}_1"], f"kpt{li}_1")
        k = g.conv(k, _np(net, f"kpt{li}_2", "kernel"),
                   _np(net, f"kpt{li}_2", "bias"), f"kpt{li}_2")

        n = hw * hw
        # anchor-center pixel grids (broadcast constants)
        ix = (np.arange(hw, dtype=np.float32) + 0.5) * stride
        cx_px = np.tile(ix[None, :], (hw, 1)).reshape(1, 1, n)
        cy_px = np.tile(ix[:, None], (1, hw)).reshape(1, 1, n)
        cx = g.const(cx_px, f"lv{li}_cx")
        cy = g.const(cy_px, f"lv{li}_cy")

        # DFL expectation -> ltrb strides -> pixel xyxy
        bx = g.reshape(b, (nb, 4, REG_MAX, n), f"lv{li}_dfl_in")
        bx = g.softmax(bx, 2, f"lv{li}_dfl_sm")
        bx = g.transpose(bx, (0, 1, 3, 2), f"lv{li}_dfl_T")
        bins = g.const(
            np.arange(REG_MAX, dtype=np.float32).reshape(REG_MAX, 1),
            f"lv{li}_bins",
        )
        dist = g.matmul(bx, bins, f"lv{li}_dfl_e")  # (1,4,n,1)
        dist = g.reshape(dist, (nb, 4, n), f"lv{li}_dist")
        sconst = g.const(np.asarray(float(stride), np.float32), f"lv{li}_s")
        dist = g.node("Mul", [dist, sconst], f"lv{li}_dist_px")
        l_ = g.slice(dist, [0], [1], [1], f"lv{li}_l")
        t_ = g.slice(dist, [1], [2], [1], f"lv{li}_t")
        r_ = g.slice(dist, [2], [3], [1], f"lv{li}_r")
        bt = g.slice(dist, [3], [4], [1], f"lv{li}_b")
        x1 = g.node("Sub", [cx, l_], f"lv{li}_x1")
        y1 = g.node("Sub", [cy, t_], f"lv{li}_y1")
        x2 = g.node("Add", [cx, r_], f"lv{li}_x2")
        y2 = g.node("Add", [cy, bt], f"lv{li}_y2")
        boxes = g.concat([x1, y1, x2, y2], 1, f"lv{li}_boxes")  # (1,4,n)

        score = g.reshape(c, (nb, num_classes, n), f"lv{li}_cls_flat")
        score = g.node("Sigmoid", [score], f"lv{li}_score")

        kp = g.reshape(k, (nb, num_keypoints, 3, n), f"lv{li}_kp")
        koff = g.const(np.asarray(KPT_OFFSET_SCALE, np.float32), f"lv{li}_ks")
        kxo = g.slice(kp, [0], [1], [2], f"lv{li}_kxo")
        kyo = g.slice(kp, [1], [2], [2], f"lv{li}_kyo")
        kco = g.slice(kp, [2], [3], [2], f"lv{li}_kco")
        cx4 = g.reshape(cx, (1, 1, 1, n), f"lv{li}_cx4")
        cy4 = g.reshape(cy, (1, 1, 1, n), f"lv{li}_cy4")
        kx = g.node("Add", [g.node("Mul", [kxo, koff], f"lv{li}_kxs"), cx4],
                    f"lv{li}_kx")
        ky = g.node("Add", [g.node("Mul", [kyo, koff], f"lv{li}_kys"), cy4],
                    f"lv{li}_ky")
        kc = g.node("Sigmoid", [kco], f"lv{li}_kc")
        kdec = g.concat([kx, ky, kc], 2, f"lv{li}_kdec")  # (1,K,3,n)
        kdec = g.reshape(kdec, (nb, num_keypoints * 3, n), f"lv{li}_kflat")

        level_outs.append(
            g.concat([boxes, score, kdec], 1, f"lv{li}_out")
        )  # (1, 4+nc+K*3, n)

    rows = 4 + num_classes + num_keypoints * 3
    total_a = sum((imgsz // s) ** 2 for s in STRIDES)
    g.concat(level_outs, 2, "decode_cat")
    g.nodes[-1].outputs = ["output0"]

    return op.Model(
        graph_name="card_corner_yolo12n_pose",
        nodes=g.nodes,
        initializers=g.initializers,
        inputs=[("input", op.FLOAT,
                 (None if dynamic_batch else batch, 3, imgsz, imgsz))],
        outputs=[("output0", op.FLOAT,
                  (None if dynamic_batch else batch, rows, total_a))],
        opset=opset,
        doc=(
            "YOLO12n-pose card corner detector, exported by "
            "mtg_card_image_segmentation_tpu (BN folded, decode in-graph). "
            "Input: NCHW fp32 in [0,1]. Output rows: [x1,y1,x2,y2,score,"
            "(kx,ky,kconf)x%d] in input pixels; apply max_det=1: box at "
            "argmax score, each keypoint at its argmax kconf column."
            % num_keypoints
        ),
    )
