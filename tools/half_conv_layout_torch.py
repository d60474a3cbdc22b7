#!/usr/bin/env python
"""Which half-precision convolutions of the port are right on the card, in
each memory layout.

    python tools/half_conv_layout_torch.py [--out FILE.jsonl]   (needs one CUDA card)

cuDNN's NCHW float16 depthwise kernel returns wrong values on the H100 (a
3x3 depthwise over 200 channels of 20x15), so the ONNX executor runs its
float16 convs channels_last (``export/onnx_torch_runner.py``). This tool
maps every other half-precision conv the port runs on the card:

1. It runs each of the port's paths once on the card, at the batch the
   path serves or trains at, and records every ``conv2d`` and
   ``conv_transpose2d`` call in float16 or bfloat16 (a
   ``TorchFunctionMode``): its shapes, stride, padding, dilation, groups,
   and the backend and memory layout that PyTorch chose for it
   (``torch._C._select_conv_backend``, ``_conv_determine_backend_memory_format``).
   The paths: the seg predictor at 512x512 b128 (dense and slim 0.3),
   320x240 b32 and b1 (the server's one image), its stock-op path at
   512x512 b128 (the block profiler's graph: blocks 12-14 as their modules,
   dilation 2) and its bf16 train forward at 320x240 b32; the HRNet
   predictor at 480x640 b32 and b128 and its train forward at b24; the YOLO
   predictor and its train forward at 640x640 b32; the float16 ONNX graphs
   of the three export CLIs at b1 through the executor.
2. For every distinct call it runs the same conv on the card in NCHW
   (input and weight contiguous) and in channels_last, cuDNN on, and holds
   images 0 and B-1 of each output against the conv in float64 on the
   host. The inputs are multiples of 1/64 in [-1, 1] and the weights
   multiples of 1/256 in [-1/16, 1/16], exact in both half types, and
   image B-1 is the negation of image 0, so the float64 reference is exact
   and one host conv serves both images; with float32 accumulation the
   only error left is the output's rounding to the half type.

Prints one JSON line per (call, dtype, layout): the relative error
(max|card - float64| over max|float64|), whether any output of the batch
is NaN, whether the port executes that layout, and the paths. A
combination is wrong when its output holds a NaN or its relative error is
over 100x its yardstick: the larger of the same call's channels_last error
and the half type's unit roundoff (2^-8 bfloat16, 2^-11 float16); a
channels_last row is held to 100 units of roundoff. The last line sums the
map, with the card's name and power limit. Exits 1 when a combination that
the port executes is wrong, 2 without a card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WRONG_FACTOR = 100.0
# unit roundoff of each half type
UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
LAYOUTS = ("nchw", "channels_last")
_CONV_ARGS = ("input", "weight", "bias", "stride", "padding", "dilation", "groups")
_DECONV_ARGS = ("input", "weight", "bias", "stride", "padding", "output_padding", "groups",
                "dilation")


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def describe_call(transposed: bool, args, kwargs) -> Optional[dict]:
    """The conv call ``conv2d(*args, **kwargs)`` (``conv_transpose2d`` when
    ``transposed``) as a hashable record, or None when its input is not
    float16 or bfloat16. ``layout``/``backend`` are what PyTorch runs it
    as."""
    import torch

    names = _DECONV_ARGS if transposed else _CONV_ARGS
    a = dict(zip(names, args), **kwargs)
    x, w, b = a["input"], a["weight"], a.get("bias")
    if x.dtype not in (torch.float16, torch.bfloat16):
        return None
    if isinstance(a.get("padding", 0), str):
        raise NotImplementedError(f"string padding {a['padding']!r}")
    stride, padding = _pair(a.get("stride", 1)), _pair(a.get("padding", 0))
    dilation, groups = _pair(a.get("dilation", 1)), int(a.get("groups", 1))
    out_pad = _pair(a.get("output_padding", 0))
    backend = torch._C._select_conv_backend(x, w, b, list(stride), list(padding),
                                            list(dilation), transposed, list(out_pad),
                                            groups, None)
    fmt = torch._C._conv_determine_backend_memory_format(x, w, backend)
    return {"transposed": transposed, "x": tuple(x.shape), "w": tuple(w.shape),
            "bias": b is not None, "stride": stride, "padding": padding,
            "dilation": dilation, "groups": groups, "output_padding": out_pad,
            "dtype": str(x.dtype).replace("torch.", ""),
            "layout": "channels_last" if fmt == torch.channels_last else "nchw",
            "backend": str(backend).split(".")[-1]}


def capture(fn: Callable[[], object]) -> List[dict]:
    """Every half-precision conv call of ``fn()`` (:func:`describe_call`)."""
    import torch
    from torch.overrides import TorchFunctionMode

    conv, deconv = torch.nn.functional.conv2d, torch.nn.functional.conv_transpose2d

    class Capture(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is conv or func is deconv:
                rec = describe_call(func is deconv, args, kwargs)
                if rec is not None:
                    self.calls.append(rec)
            return func(*args, **kwargs)

    with torch.no_grad(), Capture() as cap:
        fn()
    return cap.calls


def _key(rec: dict) -> tuple:
    return tuple((k, rec[k]) for k in sorted(rec) if k not in ("layout", "backend"))


def merge(calls_by_path: Dict[str, List[dict]]) -> Dict[tuple, dict]:
    """Distinct calls over all paths: each with the paths that make it and
    the layouts and backends it runs as there."""
    cases: Dict[tuple, dict] = {}
    for path, calls in calls_by_path.items():
        for rec in calls:
            case = cases.setdefault(_key(rec), {**{k: v for k, v in rec.items()
                                                   if k not in ("layout", "backend")},
                                                "paths": [], "executed": {}})
            if path not in case["paths"]:
                case["paths"].append(path)
            case["executed"].setdefault(rec["layout"], set()).add(rec["backend"])
    return cases


def _conv(torch, case, x, w, b):
    F = torch.nn.functional
    if case["transposed"]:
        return F.conv_transpose2d(x, w, b, case["stride"], case["padding"],
                                  case["output_padding"], case["groups"], case["dilation"])
    return F.conv2d(x, w, b, case["stride"], case["padding"], case["dilation"], case["groups"])


def measure(case: dict, device, seed: int = 0) -> List[dict]:
    """The rows of one distinct call: its conv on ``device`` in each
    layout, images 0 and B-1 against the float64 conv on the host."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    n, *img = case["x"]
    x0 = torch.randint(-64, 65, (1, *img), generator=gen, dtype=torch.float64) / 64
    w = torch.randint(-16, 17, case["w"], generator=gen, dtype=torch.float64) / 256
    b = (torch.randint(-64, 65, (case["w"][1] * case["groups"] if case["transposed"]
                                 else case["w"][0],), generator=gen, dtype=torch.float64) / 256
         if case["bias"] else None)
    ref0 = _conv(torch, case, x0, w, None)[0]
    refs = [ref0, -ref0][:min(n, 2)]
    if b is not None:
        refs = [r + b[:, None, None] for r in refs]
    scale = float(max(r.abs().max() for r in refs)) or 1.0
    dt = getattr(torch, case["dtype"])
    dgen = torch.Generator(device=device).manual_seed(seed + 1)
    x = (torch.randint(-64, 65, (n, *img), generator=dgen, device=device) / 64).to(dt)
    x[n - 1] = -x0[0].to(device, dt)
    x[0] = x0[0].to(device, dt)
    wd, bd = w.to(device, dt), None if b is None else b.to(device, dt)
    rows = []
    for layout in LAYOUTS:
        fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        with torch.no_grad():
            out = _conv(torch, case, x.contiguous(memory_format=fmt),
                        wd.contiguous(memory_format=fmt), bd)
        nan = bool(torch.isnan(out).any())
        got = [out[0].double().cpu(), out[n - 1].double().cpu()][:len(refs)]
        err = max(float((g - r).abs().max()) for g, r in zip(got, refs)) / scale
        rows.append({"layout": layout, "rel_err": err, "nan": nan,
                     "executed": layout in case["executed"],
                     "backends": sorted(case["executed"].get(layout, ()))})
    return rows


def judge(rows: List[dict], dtype: str) -> None:
    """Mark each of one call's rows ``wrong`` (in place), as the module
    docstring says."""
    u = UNIT_ROUNDOFF[dtype]
    cl = next(r["rel_err"] for r in rows if r["layout"] == "channels_last")
    for r in rows:
        stick = u if r["layout"] == "channels_last" else max(cl, u)
        r["yardstick"] = stick
        r["wrong"] = bool(r["nan"] or not r["rel_err"] <= WRONG_FACTOR * stick)


def _seg_paths(torch, dev) -> Dict[str, Callable[[], object]]:
    from mtg_card_image_segmentation_tpu_torch.compression.slim import (
        expansion_channel_prune,
        slim_seg_state,
    )
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
    from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax, init_flax_like

    params, stats = init_flax_like(0)
    slim = slim_seg_state(expansion_channel_prune(params, 0.3)[0], stats)[:2]

    def u8(b, h, w):
        return torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=dev)

    def predict(weights, h, w, b, **kw):
        return lambda: SegPredictor(*weights, h, w, device=dev, **kw).predict(u8(b, h, w))

    def train(h, w, b):
        model = from_flax(params, stats, dtype=torch.bfloat16).to(dev).train()
        return lambda: model(torch.randn((b, h, w, 3), device=dev))

    return {"seg_predict_512x512_b128": predict((params, stats), 512, 512, 128),
            "seg_slim_predict_512x512_b128": predict(slim, 512, 512, 128),
            "seg_predict_320x240_b32": predict((params, stats), 320, 240, 32),
            "seg_predict_320x240_b1": predict((params, stats), 320, 240, 1),
            "seg_stock_ops_512x512_b128": predict((params, stats), 512, 512, 128,
                                                  use_kernels=False),
            "seg_train_forward_320x240_b32": train(320, 240, 32)}


def _pose_paths(torch, dev) -> Dict[str, Callable[[], object]]:
    from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import (
        PosePredictor,
        YoloCornerPredictor,
    )
    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        hrnet_from_flax,
        init_hrnet_flax_like,
        init_yolo_flax_like,
        yolo_from_flax,
    )

    hrnet, yolo = init_hrnet_flax_like(0), init_yolo_flax_like(0)

    def u8(b, h, w):
        return torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=dev)

    def pose(b):
        return lambda: PosePredictor(*hrnet, 480, 640, device=dev).predict(u8(b, 480, 640))

    def pose_train(b):
        model = hrnet_from_flax(*hrnet, (120, 160), dtype=torch.bfloat16).to(dev).train()
        return lambda: model(torch.rand((b, 480, 640, 3), device=dev))

    def yolo_predict(b):
        return lambda: YoloCornerPredictor(*yolo, 640, device=dev).predict(u8(b, 640, 640))

    def yolo_train(b):
        model = yolo_from_flax(*yolo, dtype=torch.bfloat16).to(dev).train()
        return lambda: model.levels(torch.rand((b, 640, 640, 3), device=dev))

    return {"hrnet_predict_480x640_b32": pose(32), "hrnet_predict_480x640_b128": pose(128),
            "hrnet_train_forward_480x640_b24": pose_train(24),
            "yolo_predict_640x640_b32": yolo_predict(32),
            "yolo_train_forward_640x640_b32": yolo_train(32)}


def _export_paths(torch, dev) -> Dict[str, Callable[[], object]]:
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
    from mtg_card_image_segmentation_tpu_torch.export.onnx_export import (
        convert_to_fp16,
        export_pose_model,
        export_seg_model,
    )
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
    from mtg_card_image_segmentation_tpu_torch.export.onnx_yolo import export_yolo_model
    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        init_flax_like,
        init_hrnet_flax_like,
        init_yolo_flax_like,
    )

    graphs = {
        "seg_fp16_onnx_320x240_b1": ((320, 240), lambda: export_seg_model(
            fold_batch_norm(*init_flax_like(0)), (320, 240), 2, 128, opset=19)),
        "hrnet_fp16_onnx_480x640_b1": ((480, 640), lambda: export_pose_model(
            fold_batch_norm(*init_hrnet_flax_like(0)), (480, 640), (120, 160))),
        "yolo_fp16_onnx_640x640_b1": ((640, 640), lambda: export_yolo_model(
            fold_batch_norm(*init_yolo_flax_like(0)), 640, opset=19)),
    }

    def run(hw, build):
        runner = make_runner(convert_to_fp16(build(), keep_io_types=True), dev)
        x = np.random.default_rng(0).random((1, 3, *hw), np.float32)
        return lambda: runner({"input": x})

    return {name: run(hw, build) for name, (hw, build) in graphs.items()}


def run(device: str = "cuda", paths: Optional[Dict[str, Callable[[], object]]] = None,
        emit: Optional[Callable[[dict], None]] = None) -> dict:
    """Capture ``paths`` (default: all of the module docstring's) on
    ``device``, measure every distinct call and return the summary;
    ``emit`` gets each row."""
    import torch

    from mtg_card_image_segmentation_tpu_torch.utils.platform import (
        nvidia_smi_name_power,
        resolve_device,
    )

    dev = resolve_device(device)
    t0 = time.perf_counter()
    if paths is None:
        paths = {**_seg_paths(torch, dev), **_pose_paths(torch, dev),
                 **_export_paths(torch, dev)}
    calls = {name: capture(fn) for name, fn in paths.items()}
    del paths  # the paths hold their models: free the card before measuring
    t_capture = time.perf_counter() - t0
    cases = merge(calls)
    summary: Dict[str, dict] = {}
    wrong_executed, wrong_other = [], []
    for i, case in enumerate(cases.values()):
        rows = measure(case, dev, seed=i)
        judge(rows, case["dtype"])
        for r in rows:
            row = {"call": {k: v for k, v in case.items() if k not in ("paths", "executed")},
                   "paths": case["paths"], **r}
            s = summary.setdefault(f"{case['dtype']}/{r['layout']}",
                                   {"calls": 0, "executed": 0, "max_rel_err": 0.0,
                                    "nan": 0, "wrong": 0, "wrong_executed": 0})
            s["calls"] += 1
            s["executed"] += r["executed"]
            s["max_rel_err"] = max(s["max_rel_err"], r["rel_err"])
            s["nan"] += r["nan"]
            s["wrong"] += r["wrong"]
            s["wrong_executed"] += r["wrong"] and r["executed"]
            if r["wrong"]:
                (wrong_executed if r["executed"] else wrong_other).append(row)
            if emit is not None:
                emit(row)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    cuda = dev.type == "cuda"
    return {"tool": "half_conv_layout", "paths": {k: len(v) for k, v in calls.items()},
            "distinct_calls": len(cases), "by_dtype_layout": summary,
            "wrong_executed": wrong_executed, "wrong_not_executed": wrong_other,
            "capture_seconds": t_capture, "seconds": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(dev) if cuda else "host CPU",
            "nvidia_smi": nvidia_smi_name_power() if cuda else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write every row to this JSONL file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("half_conv_layout_torch: needs a CUDA card", file=sys.stderr)
        return 2
    with open(args.out, "w") if args.out else contextlib.nullcontext() as sink:
        def emit(row):
            line = json.dumps(row)
            print(line)
            if sink is not None:
                sink.write(line + "\n")

        rec = run("cuda", emit=emit)
    print(json.dumps(rec), flush=True)
    return 1 if rec["wrong_executed"] else 0


if __name__ == "__main__":
    sys.exit(main())
