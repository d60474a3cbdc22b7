"""Device resolution and the description of the card.

The port's entry points run on the CUDA card. The CPU is used only when a
caller asks for it (``device="cpu"``), as the tests do: there is no silent
fallback from the card to the host.
"""

from __future__ import annotations

import subprocess
from contextlib import contextmanager
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for (or implied) but
    absent. ``"cpu"`` must be passed explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextmanager
def no_tf32():
    """fp32 convolutions and matmuls in true fp32 inside the block: cuDNN's
    convolutions default to TF32 on the H100, which breaks fp32 parity
    gates at 1e-4. The previous settings come back on exit."""
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


@contextmanager
def ieee_fp32():
    """float32 convolutions with the host's accuracy inside the block: TF32
    off and cuDNN off, so convs run as torch's own CUDA kernels (im2col and
    a cuBLAS GEMM; depthwise by its own kernel). cuDNN's fp32 convolutions
    on the H100 (cuDNN 9.2) sum long reductions with several times the
    host's rounding error (the head's 3x3 conv over 960 channels: 2.8e-6 of
    its output against oneDNN's 4.4e-7), which puts the 1e-4 fp32 export
    gate inside their noise. The previous settings come back on exit."""
    kept = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        with no_tf32():
            yield
    finally:
        torch.backends.cudnn.enabled = kept


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    first line, as the tool prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def describe_card(index: int = 0) -> dict:
    """Name, compute capability and power limit of CUDA card ``index``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    major, minor = torch.cuda.get_device_capability(index)
    return {
        "name": torch.cuda.get_device_name(index),
        "capability": f"{major}.{minor}",
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_name_power(),
    }
