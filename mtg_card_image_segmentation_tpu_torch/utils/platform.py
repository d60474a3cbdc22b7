"""Device resolution and the description of the card.

The port's entry points run on the CUDA card. The CPU is used only when a
caller asks for it (``device="cpu"``), as the tests do: there is no silent
fallback from the card to the host.
"""

from __future__ import annotations

import subprocess
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
