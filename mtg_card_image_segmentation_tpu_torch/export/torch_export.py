"""``torch.export`` artifact, the second serialization format beside ONNX
(counterpart of the JAX package's ``export/stablehlo.py``).

The reference exports TorchScript beside ONNX (train/export.py:167-244);
the JAX package writes a ``jax.export`` StableHLO artifact; the port writes
a ``torch.export`` ``ExportedProgram`` (``.pt2``): a graph of ATen ops with
its weights, which ``torch.export.load`` runs without the model's Python
code. Each file carries the reference's self-test (the reloaded program
against the source module, max|diff| < 1e-5) and a JSON sidecar.

The graph records the device it was exported on: constants it makes (an
anchor grid's ``arange``) carry that device in their arguments.
``serving/artifact_backend.py::load_program`` moves a program with
``torch.export.passes.move_to_device_pass``, never with ``.to()``, which
would move the weights and leave those nodes where they were.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import nullcontext
from typing import Tuple

import torch
import torch.nn as nn

from mtg_card_image_segmentation_tpu_torch.utils.platform import ieee_fp32

FORMAT = "torch.export ExportedProgram (.pt2)"


class NCHW(nn.Module):
    """An NHWC module behind the deployment contract: NCHW float32 in, NCHW
    out (``export_seg.py``'s and ``export_pose.py``'s ``_nchw_fn``)."""

    def __init__(self, module: nn.Module) -> None:
        super().__init__()
        self.module = module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.module(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class YoloOutput0(nn.Module):
    """``YOLO12Pose`` behind the ONNX graph's contract: NCHW float32 in, the
    (B, 4 + nc + 3K, A) ``output0`` of boxes, scores and keypoints out
    (``export_yolo.py``'s ``_output0_fn``)."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        boxes, scores, kpts = self.model(x.permute(0, 2, 3, 1))
        b, a = boxes.shape[:2]
        kk = kpts.permute(0, 2, 3, 1).reshape(b, -1, a)
        return torch.cat([boxes.transpose(1, 2), scores.transpose(1, 2), kk], dim=1)


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _spec(t: torch.Tensor) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


def export_program(module: nn.Module, example_args: Tuple[torch.Tensor, ...], path: str,
                   self_test: bool = True, atol: float = 1e-5) -> dict:
    """Export ``module`` (set to ``eval()``) at the shapes of
    ``example_args`` with ``torch.export.export``, write it to ``path``
    with ``torch.export.save`` and the sidecar ``path + ".json"`` (the JAX
    sidecar's fields, ``device`` in place of ``platforms``, and the seconds
    the export and the save took); returns the sidecar's dict.

    The self-test reloads ``path`` and runs it and ``module`` on
    ``example_args``; a max|diff| of ``atol`` or more raises ``ValueError``.
    On the card both run under ``ieee_fp32()``: cuDNN's choice of algorithm
    alone can part the eager module from the reloaded graph."""
    module.eval()
    device = example_args[0].device
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    torch.export.save(program, path)
    seconds = time.perf_counter() - t0
    with torch.no_grad(), (ieee_fp32() if device.type == "cuda" else nullcontext()):
        ref = _leaves(module(*example_args))
        got = _leaves(torch.export.load(path).module()(*example_args)) if self_test else None
    info = {
        "format": FORMAT,
        "inputs": [_spec(a) for a in example_args],
        "outputs": [_spec(o) for o in ref],
        "device": str(device),
        "bytes": os.path.getsize(path),
        "export_seconds": seconds,
        "torch_version": torch.__version__,
    }
    if self_test:
        max_diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(ref, got))
        info["self_test_max_diff"] = max_diff
        info["self_test_pass"] = bool(max_diff < atol)
        if not info["self_test_pass"]:
            raise ValueError(f"torch.export roundtrip diff {max_diff} >= {atol}")
    with open(path + ".json", "w") as f:
        json.dump(info, f, indent=2)
    return info

