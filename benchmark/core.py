"""The benchmark's machinery, shared by every cell: finding a cell's files by
name, the closed-loop window, the traced slice and what is read from it.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name that ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<mix>.json`` (the mix's parameters and the name of the general
generator that reads them, ``generators/<generator>.py``),
``programs/<program>.py``, ``reference/<config>.py``,
``metrics/<metric>.py``, ``work/<name>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import re
import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PORT = "mtg_card_image_segmentation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mtg_card_image_segmentation_tpu")

_MODULES: Dict[Path, object] = {}


def load_json(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def load_module(rel: str):
    """A module of the benchmark by its file (names may hold dots and
    dashes, so they are loaded by path), once per process."""
    path = BENCH / rel
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            "bench_" + re.sub(r"\W", "_", rel[:-3]), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(man: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics this cell reports: the end-to-end ones untraced, the
    per-layer ones traced; a metric without ``workloads`` is every cell's."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name, taken whole, is JAX's, Flax's,
    optax's or the JAX package's (the port's name begins with the JAX
    package's, so a prefix would be wrong)."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def quantile(values: List[float], q: int) -> float:
    """The q-th percentile of all values (``statistics.quantiles``,
    inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def port_kernel_names() -> set:
    """Names of the ``__global__`` functions of the port's CUDA sources, by
    which a traced kernel is the port's own or a library's."""
    names = set()
    for src in (ROOT / PORT / "csrc").glob("*.cu"):
        text = src.read_text()
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                text))
    return names


# ------------------------------------------------- readers' shared arithmetic

def roofline(run, work_file: str) -> Optional[float]:
    """Share of the least time that a batch's work can take on the card
    (``work_file``: bytes and operations counted from the problem's shapes,
    the larger of the two bounds) in the device time of its kernels per
    batch, in the traced slice. Nothing when the slice ran none of them."""
    from peaks import bound_s

    tr = run.trace
    if tr is None or not tr.items:
        return None
    work = run.work(work_file)
    us = tr.sum_us(work.ran)
    if not us:
        return None
    least, _by = bound_s(*work.count(run.cell, run.cfg))
    return 100.0 * least * len(tr.items) / (us * 1e-6)


def idle_share(run) -> Optional[float]:
    """Share of the traced slice in which no operation ran on the device:
    one minus the union of the device's operation intervals over the whole
    slice, host gaps before, between and after them included."""
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us() / (tr.t1 - tr.t0))


# ----------------------------------------------------------------- the window

@dataclass
class Item:
    """One batch or step: when it was handed over, when the call returned,
    when its outputs were complete on the card (host clock, seconds)."""
    index: int
    t_hand: float
    t_ret: float
    t_done: float = float("nan")
    images: int = 0
    traced: bool = False


@dataclass
class Window:
    t_start: float
    t_end: float
    items: List[Item] = field(default_factory=list)
    kept: Dict[int, object] = field(default_factory=dict)  # index -> outputs
    trace: Optional["Trace"] = None
    gc: Dict = field(default_factory=dict)
    clock: Dict = field(default_factory=dict)

    def done(self) -> List[Item]:
        """Items whose outputs were complete inside the window."""
        return [i for i in self.items if i.t_done <= self.t_end]


def gc_timer():
    """Count the interpreter's garbage collections and their pauses (the
    smoke script's ``gc_timer``)."""
    pauses, start = [], [0.0]

    def cb(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], (time.perf_counter() - start[0]) * 1e3))

    gc.callbacks.append(cb)

    def stop() -> dict:
        gc.callbacks.remove(cb)
        return {"collections": len(pauses), "full": sum(g == 2 for g, _ in pauses),
                "max_pause_ms": max((ms for _, ms in pauses), default=0.0),
                "total_ms": sum(ms for _, ms in pauses)}

    return stop


class HostEvent:
    """A timing CUDA event's stand-in for a run on the host (the CPU tests):
    it completes when it is recorded."""

    def __init__(self):
        self.t = float("nan")

    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


class CardClock:
    """Completion times of events on the host's clock. One event is
    recorded on an idle card and waited for; the host's readings just
    before the record and just after the wait bracket its completion, and
    their middle is taken as its time. Every later event's completion is
    that time plus the card's own elapsed time between the two events. So
    a batch's completion is when the card finished it, whatever the host
    was doing then."""

    def __init__(self, torch, event: Callable):
        if event is None:
            torch.cuda.synchronize()
        self.event = event or (lambda: torch.cuda.Event(enable_timing=True))
        self.base, self.t_base, self.bracket_s = self.stamp()

    def stamp(self) -> tuple:
        ev = self.event()
        t_a = time.perf_counter()
        ev.record()
        ev.synchronize()
        t_b = time.perf_counter()
        return ev, 0.5 * (t_a + t_b), t_b - t_a

    def done(self, ev) -> float:
        """Host-clock time at which ``ev`` (already waited for) completed."""
        return self.t_base + self.base.elapsed_time(ev) * 1e-3

    def offset_ms(self) -> float:
        """On an idle card, a fresh stamp's time by this clock less its time
        by the host's readings: the mapping's error at the end (drift and
        the bracket's width)."""
        ev, t, _ = self.stamp()
        return (self.done(ev) - t) * 1e3


def closed_loop(torch, step: Callable[[int], tuple], seconds: float, depth: int,
                keep: set, trace_items: int = 0, trace_after: int = 0,
                event: Callable = None) -> Window:
    """Run ``step(k) -> (outputs, images)`` back to back for ``seconds``,
    one client with at most ``depth`` items handed over ahead of the one it
    waits for. Each item's completion is the card's time of a timing CUDA
    event recorded behind it, on the host's clock (``CardClock``), and not
    the moment the client gets round to waiting for it: with the host
    busy handing over the next item that would add the host's turn to
    every item's time. Outputs of the items in ``keep`` (and of the last one
    complete in the window, or the first complete at all) are held for the
    check.

    With ``trace_items``, items ``trace_after`` .. ``trace_after +
    trace_items - 1`` run under the profiler, which records the device's
    operations only (recording every host operation as well costs
    microseconds each, which would slow a host-bound cell's slice and fake
    its idle share). The queue is drained before and after them, so the
    slice holds exactly their work, and a traced run goes on past
    ``seconds`` until its slice is whole."""
    from torch.profiler import ProfilerActivity, profile

    prof = None
    pending: deque = deque()
    win = Window(t_start=0.0, t_end=0.0)
    last = [None, None]
    clock = {}

    def finish(entry):
        item, ev, out = entry
        ev.synchronize()
        item.t_done = card.done(ev)
        win.items.append(item)
        if item.index in keep:
            win.kept[item.index] = out
        if item.t_done <= win.t_end or last[0] is None:  # the first, if none is in time
            last[0], last[1] = item.index, out

    def drain():
        while pending:
            finish(pending.popleft())

    if trace_items:  # the profiler's first start (CUPTI) outside the window
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    card = CardClock(torch, event)
    stop_gc = gc_timer()
    win.t_start = time.perf_counter()
    win.t_end = win.t_start + seconds
    k, traced_all = 0, False
    while time.perf_counter() < win.t_end or (trace_items and not traced_all):
        if trace_items and k == trace_after:
            drain()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            clock["ns0"], clock["pc0"] = time.time_ns(), time.perf_counter()
        tracing = prof is not None and not traced_all
        t_hand = time.perf_counter()
        out, images = step(k)
        t_ret = time.perf_counter()
        ev = card.event()
        ev.record()
        pending.append((Item(k, t_hand, t_ret, images=images, traced=tracing), ev, out))
        k += 1
        while len(pending) > depth:
            finish(pending.popleft())
        if tracing and k == trace_after + trace_items:
            drain()
            clock["ns1"] = time.time_ns()
            prof.__exit__(None, None, None)
            traced_all = True
    drain()
    win.gc = stop_gc()
    win.clock = {"bracket_ms": card.bracket_s * 1e3,
                 "offset_ms_at_end": card.offset_ms()}
    if last[0] is not None:
        win.kept[last[0]] = last[1]
    if prof is not None:
        win.trace = Trace.read(torch, prof, [i for i in win.items if i.traced], clock)
    return win


# ------------------------------------------------------------------ the trace

@dataclass
class Trace:
    """What the profiler saw in the traced slice: every device operation as
    (name, start, end) in microseconds from the slice's start, and the
    harness's own host spans on the same clock (the profiler stamps events
    with the wall clock in nanoseconds; the host spans are mapped onto it
    from one reading of both clocks at the slice's start)."""
    t0: float
    t1: float
    device: List[tuple]
    host: List[tuple]
    items: List[Item]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def images(self) -> int:
        return sum(i.images for i in self.items)

    @classmethod
    def read(cls, torch, prof, items: List[Item], clock: dict) -> "Trace":
        ns0, pc0 = clock["ns0"], clock["pc0"]
        dev = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
                continue
            dev.append((e.name(), (e.start_ns() - ns0) * 1e-3, (e.end_ns() - ns0) * 1e-3))
        t1 = (clock["ns1"] - ns0) * 1e-3
        dev = [d for d in dev if d[2] > 0.0 and d[1] < t1]

        def us(t):
            return (t - pc0) * 1e6

        host = [("in the program's call", us(i.t_hand), us(i.t_ret)) for i in items]
        host += [("in the harness, between calls", us(a.t_ret), us(b.t_hand))
                 for a, b in zip(items, items[1:])]
        return cls(0.0, t1, dev, host, items)

    def busy_us(self) -> float:
        """Union of the device operations' intervals, clipped to the slice."""
        spans = sorted((max(s, self.t0), min(e, self.t1)) for _, s, e in self.device)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def sum_us(self, pred: Callable[[str], bool]) -> float:
        """Summed device time of the operations that ``pred`` takes."""
        return sum(min(e, self.t1) - max(s, self.t0) for n, s, e in self.device if pred(n))

    def gaps(self) -> List[tuple]:
        """(start, end) of the device's idle intervals inside the slice."""
        spans = sorted((s, e) for _, s, e in self.device)
        out, cur = [], self.t0
        for s, e in spans:
            if s > cur:
                out.append((cur, min(s, self.t1)))
            cur = max(cur, e)
        if cur < self.t1:
            out.append((cur, self.t1))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the innermost host operation running at each gap's middle."""
        import numpy as np

        per_op: Dict[str, float] = {}
        for n, s, e in self.device:
            key = n[:96]
            per_op[key] = per_op.get(key, 0.0) + (min(e, self.t1) - max(s, self.t0)) * 1e-6
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:2000]
        hs = np.array([h[1] for h in self.host], dtype=np.float64)
        he = np.array([h[2] for h in self.host], dtype=np.float64)
        by_host: Dict[str, float] = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            cover = np.nonzero((hs <= mid) & (he >= mid))[0] if len(hs) else []
            name = "no host operation" if len(cover) == 0 else \
                self.host[int(cover[np.argmax(hs[cover])])][0][:96]
            by_host[name] = by_host.get(name, 0.0) + (e - s) * 1e-6
        return {"device_ops": sorted(([n, v] for n, v in per_op.items()),
                                     key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([n, v] for n, v in by_host.items()),
                                    key=lambda x: -x[1])[:top]}
