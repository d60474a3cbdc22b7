"""Profiling and tracing of the port:

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  chrome trace (``trace.json``, which ``chrome://tracing`` and Perfetto
  open) into a directory (the JAX package's name);
- :class:`Span`: one span site of the serving path, in one of three layers
  (``entry``, ``stock``, ``kernels``). It records only while a torch
  profiler session runs (``torch.autograd.profiler._is_profiler_enabled``,
  which torch sets and clears on every session's start and stop), so a run
  with no profiler pays one attribute read at each site;
- :func:`spans`: the records, kept in memory in a bounded buffer of the
  newest ``MAX_RECORDS``.

A record holds the span's name and layer, its parent (the span open around
it on the same thread), its start and end on ``time.perf_counter_ns`` and
the port's kernel launches inside it (``ops/kernels/_build.py``'s running
total, read at entry and exit).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build

LAYERS = ("entry", "stock", "kernels")
MAX_RECORDS = 65536


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


class SpanRecord(NamedTuple):
    """One recorded span: ``parent`` is the ``id`` of the span open around
    it on its thread (``None`` for a root); times are
    ``time.perf_counter_ns``; ``launches`` counts the port's kernel
    launches between its start and end."""
    id: int
    parent: Optional[int]
    name: str
    layer: str
    start_ns: int
    end_ns: int
    launches: int


_RECORDS: deque = deque(maxlen=MAX_RECORDS)  # SpanRecord fields as plain tuples
_IDS = itertools.count(1)
# one entry per recorded span open on any thread (list.append and list.pop
# are atomic): a span's exit reads only this while it is empty
_OPEN: list = []


class _Stack(threading.local):
    def __init__(self) -> None:
        self.frames: list = []


_STACK = _Stack()


class Span:
    """A span site, built once where the work happens and entered on every
    call (``with SITE: ...``); entering it allocates nothing while no
    profiler runs."""

    __slots__ = ("name", "layer")

    def __init__(self, name: str, layer: str) -> None:
        if layer not in LAYERS:
            raise ValueError(f"layer must be one of {LAYERS}, got {layer!r}")
        self.name, self.layer = name, layer

    def __enter__(self) -> None:
        if _autograd_profiler._is_profiler_enabled:
            frames = _STACK.frames
            _OPEN.append(None)
            frames.append((self, next(_IDS), frames[-1][1] if frames else None,
                           _build.launch_total(), time.perf_counter_ns()))

    def __exit__(self, exc_type, exc, tb) -> None:
        if _OPEN:
            frames = _STACK.frames
            if frames and frames[-1][0] is self:
                end = time.perf_counter_ns()
                _, sid, parent, launches, start = frames.pop()
                _RECORDS.append((sid, parent, self.name, self.layer, start, end,
                                 _build.launch_total() - launches))
                _OPEN.pop()


def spans() -> List[SpanRecord]:
    """The recorded spans, oldest first (a span is recorded when it ends,
    so children come before their parents)."""
    return [SpanRecord._make(r) for r in list(_RECORDS)]
