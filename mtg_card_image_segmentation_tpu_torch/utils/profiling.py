"""Profiling and tracing utilities (counterpart of the JAX package's
``utils/profiling.py``, with its names):

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  chrome trace (``trace.json``, which ``chrome://tracing`` and Perfetto
  open) into a directory;
- :func:`fence`: waits for everything queued on a tensor's device;
- :class:`StepTimer`: step timing with a fence at each step's end and the
  first ``warmup`` steps discarded;
- :func:`device_memory_stats`: each CUDA card's memory in use, its peak and
  its total, under the JAX keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, python_tracer: bool = False):
    """``with trace("logs/profile"): run_steps()`` -> ``log_dir/trace.json``.
    Host (CPU) activity always, the card's kernels when CUDA is up; the
    Python call stacks only with ``python_tracer`` (they can outnumber the
    device events many times over, as the JAX function's note says)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, with_stack=python_tracer) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(x) -> Optional[torch.Tensor]:
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def fence(x) -> None:
    """Wait until everything queued before ``x`` (a tensor, or the first
    tensor of a dict, list or tuple) has run on its device: the card's
    stream is in order, so synchronizing it is enough. Host tensors are
    ready as soon as they exist."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Accumulates wall-clock per step with fenced boundaries.

    >>> timer = StepTimer(warmup=3)
    >>> for batch in data:
    ...     with timer.step():
    ...         out = train_step(...)
    ...     timer.mark(out)   # fence + record
    """

    def __init__(self, warmup: int = 3) -> None:
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._seen = 0

    @contextlib.contextmanager
    def step(self):
        self._t0 = time.perf_counter()
        yield

    def mark(self, out) -> None:
        fence(out)
        self.record(time.perf_counter() - self._t0)

    def record(self, seconds: float) -> None:
        """One step's time; the first ``warmup`` steps are discarded."""
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(seconds)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "median_ms": float(np.median(arr) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


def device_memory_stats() -> List[Dict]:
    """Per CUDA card: ``bytes_in_use`` and ``peak_bytes_in_use`` of the
    caching allocator (``torch.cuda.memory_stats``) and ``bytes_limit``, the
    card's total memory; an empty list without CUDA."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out
