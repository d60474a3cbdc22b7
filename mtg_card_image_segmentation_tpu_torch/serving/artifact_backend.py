"""Deployment-artifact inference backend for the inference CLIs
(counterpart of the JAX package's ``serving/artifact_backend.py``).

The reference inference CLI runs either the checkpoint or the exported
``.onnx`` with an fp16-session fallback ladder
(train-pose-estimation_custom/inference_test.py:64-139); the browser demo
walks a model ladder int8 -> fp16 -> fp32 on wasm
(demo/src/model-inference.js). :func:`load_onnx` loads a shipped ONNX file,
or walks a package directory's int8 -> fp16 -> fp32 -> dynamic ladder,
behind one ``fn(x_nchw) -> output`` callable executed by the port's torch
executor (``export/onnx_torch_runner.py``) on the device.

The ladder is the reference's feature, not a device fallback: a rung that
fails to load or to run falls to the next one, and the reason is kept, so
that a caller can see (and a smoke run can refuse) a fall.

:func:`load_program` runs the port's ``torch.export`` artifact
(``model.pt2``, ``pose.pt2``, ``yolo.pt2``; ``export/torch_export.py``), the
counterpart of the JAX package's ``load_stablehlo``: one file, no ladder
and no fallback.
"""

from __future__ import annotations

import os
from typing import Callable, List, Tuple

import numpy as np

# package-directory ladders, preferred artifact first (smallest download
# that still clears the export parity gates — mirrors the demo's wasm
# model ladder int8 -> fp16 -> fp32)
ONNX_LADDERS = {
    "seg": ["model_int8.onnx", "model_fp16.onnx", "model.onnx",
            "model_dynamic.onnx"],
    "hrnet": ["pose_int8.onnx", "pose_fp16.onnx", "pose.onnx",
              "pose_dynamic.onnx"],
    "yolo": ["yolo_int8.onnx", "yolo_fp16.onnx", "yolo.onnx",
             "yolo_dynamic.onnx"],
}
# the torch.export artifact of each family (the JAX package's STABLEHLO_NAMES)
PROGRAM_NAMES = {"seg": "model.pt2", "hrnet": "pose.pt2", "yolo": "yolo.pt2"}


def _onnx_candidates(path: str, family: str) -> List[str]:
    if os.path.isdir(path):
        return [
            os.path.join(path, n)
            for n in ONNX_LADDERS[family]
            if os.path.exists(os.path.join(path, n))
        ]
    return [path]


def load_onnx(path: str, family: str, device=None) -> Tuple[Callable, str, List[str]]:
    """``path`` is an .onnx file or a deployment-package directory.
    Directories walk the family's int8 -> fp16 -> fp32 -> dynamic ladder,
    falling to the next artifact if one fails to load or to run (the
    reference's session fallback ladder, inference_test.py:102-129). Every
    candidate is probed with zeros at its declared input shape (a symbolic
    batch as 1) on ``device`` (``None``: the CUDA card).

    Returns (runner, chosen_path, reasons): the runner maps fp32 NCHW numpy
    -> numpy output, ``reasons`` holds one ``"<file>: <error>"`` per rung
    that fell. Raises ``RuntimeError`` with every reason when all fail."""
    from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner

    candidates = _onnx_candidates(path, family)
    if not candidates:
        raise FileNotFoundError(
            f"no {family} ONNX artifacts in {path} "
            f"(looked for {ONNX_LADDERS[family]})"
        )
    reasons: List[str] = []
    for cand in candidates:
        try:
            model = op.Model.load(cand)
            runner = make_runner(model, device)
            in_name = model.inputs[0][0]
            out_name = model.outputs[0][0]
            # probe-execute at the declared input shape (dynamic/symbolic
            # batch -> 1) so artifacts that parse but cannot run — e.g. an
            # op outside the executor's set — also fall down the ladder,
            # like the reference's session-create probe
            shape = tuple(
                1 if not isinstance(d, int) or d <= 0 else d
                for d in model.inputs[0][2]
            )
            runner({in_name: np.zeros(shape, np.float32)})

            def fn(x, _runner=runner, _in=in_name, _out=out_name):
                return _runner({_in: np.asarray(x, np.float32)})[_out]

            return fn, cand, reasons
        except Exception as e:  # fall down the ladder, remember why
            reasons.append(f"{os.path.basename(cand)}: {e}")
    raise RuntimeError(
        "every ONNX artifact in the ladder failed: " + "; ".join(reasons)
    )


def load_program(path: str, family: str, device=None) -> Tuple[Callable, str]:
    """``path`` is a ``.pt2`` file or a package directory (the family's
    :data:`PROGRAM_NAMES` file in it). The program is moved to ``device``
    (``None``: the CUDA card) by ``move_to_device_pass``, which also moves
    the devices written into the graph's nodes. Returns (runner,
    chosen_path): the runner maps float32 NCHW numpy or a tensor to the
    output as numpy. A file that does not load raises."""
    import torch
    from torch.export.passes import move_to_device_pass

    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    if os.path.isdir(path):
        path = os.path.join(path, PROGRAM_NAMES[family])
    program = move_to_device_pass(torch.export.load(path), device).module()

    def fn(x):
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))
        with torch.no_grad():
            return program(x.to(device, torch.float32)).cpu().numpy()

    return fn, path
