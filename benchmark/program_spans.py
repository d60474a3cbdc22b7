"""The port's own spans (``utils/profiling.py``: ``Span`` sites in the
predictors and the kernel wrappers, recorded while the traced slice's
profiler runs) on the slice's clock, for the ``*_host_ms``, ``*_idle_ms``
and ``kernel_launches`` readers.

- The clock: spans are stamped with ``time.perf_counter_ns``, the clock of
  the harness's ``Item.t_hand``. ``core.Trace.read`` writes the program-call
  spans first, in item order, so the first traced item's ``t_hand`` sits at
  ``trace.host[0][1]`` microseconds of the slice: the difference is the
  offset.
- Only spans inside the slice are kept, and only whole trees. Every traced
  call must hold the same root spans (``seg.predict``; ``pose.heatmaps``
  then ``pose.decode``) and every root must lie in a call, or there is
  nothing to read (``None``): so a program without spans (one from before
  the spans were added) reads nothing.
- A span's self time is its duration less what its children cover.
- Each idle gap of the device (``Trace.gaps``) is split by overlap among the
  self intervals of the spans, so it is put down to the layer of the
  innermost span open at each instant. What no span covers is the
  harness's: the three layers and the harness add up to the slice's idle
  time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

LAYERS = ("entry", "stock", "kernels")


@dataclass
class ProgramSpans:
    """Sums over the slice's spans (microseconds), and its batches."""
    batches: int
    self_us: Dict[str, float]
    idle_us: Dict[str, float]
    harness_idle_us: float
    launches: int

    def host_ms(self, layer: str) -> float:
        return self.self_us[layer] * 1e-3 / self.batches

    def idle_ms(self, layer: str) -> float:
        return self.idle_us[layer] * 1e-3 / self.batches


def records() -> Optional[list]:
    """The port's span records, or ``None`` where the port keeps none."""
    from mtg_card_image_segmentation_tpu_torch.utils import profiling

    get = getattr(profiling, "spans", None)
    return None if get is None else get()


def of(run) -> Optional[ProgramSpans]:
    """``measure`` of the run's slice and the port's records, once per run."""
    if not hasattr(run, "program_spans"):
        recs = records() if run.trace is not None else None
        run.program_spans = measure(run.trace, recs) if recs else None
    return run.program_spans


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Summed overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def measure(tr, recs) -> Optional[ProgramSpans]:
    """Self time, idle time by layer and launches of the spans ``recs``
    (``profiling.SpanRecord``s) in the traced slice ``tr``."""
    if tr is None or not tr.items or len(tr.host) < len(tr.items) or not recs:
        return None
    zero = tr.items[0].t_hand * 1e6 - tr.host[0][1]  # perf_counter us at the slice's 0
    spans = {}
    for r in recs:
        s, e = r.start_ns * 1e-3 - zero, r.end_ns * 1e-3 - zero
        if tr.t0 <= s and e <= tr.t1:
            spans[r.id] = (r, s, e)
    children: Dict[int, list] = {}
    for sid, (r, _s, _e) in spans.items():
        if r.parent is not None:
            children.setdefault(r.parent, []).append(sid)
    roots = sorted((v for v in spans.values() if v[0].parent is None), key=lambda v: v[1])
    calls = tr.host[:len(tr.items)]
    per_call: List[list] = [[] for _ in calls]
    for r, s, e in roots:
        k = next((k for k, (_n, cs, ce) in enumerate(calls) if cs <= s and e <= ce), None)
        if k is None:
            return None
        per_call[k].append(r.name)
    if not per_call[0] or any(names != per_call[0] for names in per_call):
        return None

    own: Dict[str, list] = {layer: [] for layer in LAYERS}
    todo = [v[0].id for v in roots]
    while todo:
        sid = todo.pop()
        r, s, e = spans[sid]
        kids = [k for k in children.get(sid, ()) if k in spans]
        todo.extend(kids)
        cover = _union([(max(s, spans[k][1]), min(e, spans[k][2])) for k in kids])
        cur = s
        for cs, ce in cover:
            if cs > cur:
                own[r.layer].append((cur, cs))
            cur = max(cur, ce)
        if e > cur:
            own[r.layer].append((cur, e))
    gaps = _union(tr.gaps())
    mine = {layer: _union(own[layer]) for layer in LAYERS}
    idle = {layer: _overlap(gaps, mine[layer]) for layer in LAYERS}
    return ProgramSpans(
        batches=len(tr.items),
        self_us={layer: sum(e - s for s, e in mine[layer]) for layer in LAYERS},
        idle_us=idle,
        harness_idle_us=sum(e - s for s, e in gaps) - sum(idle.values()),
        launches=sum(r.launches for r, _s, _e in roots))
