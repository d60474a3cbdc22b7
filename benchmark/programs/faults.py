"""Faults planted under the timed path, to show that ``correct`` comes out
false when the program goes wrong in the ways a serve cell can: a step
that returns its state unchanged (a served batch answered with the
previous batch's outputs), half of the batch left out (the second half of
a served batch's outputs zero), and an answer altered where it is produced
(image 0 given image 1's answer: its mask, or its corners and
confidences, the heatmaps they came from left as they were).
``run.py --fault <name>`` plants one; the benchmark's own runs plant none.
"""

from __future__ import annotations

SERVE = ("stale", "half", "altered")


def _map(out, fn):
    return tuple(fn(t) for t in out) if isinstance(out, tuple) else fn(out)


class Planted:
    """``program`` with ``fault`` planted in its ``step``; everything else
    is the program's."""

    def __init__(self, program, fault: str):
        if fault not in SERVE:
            raise ValueError(f"no fault {fault!r} for this cell")
        self._program, self._fault = program, fault
        self._previous = None

    def __getattr__(self, name):
        return getattr(self._program, name)

    def step(self, *args):
        out = self._program.step(*args)
        if self._fault == "stale":
            out, self._previous = (self._previous if self._previous is not None else out), out
        elif self._fault == "half":
            def halve(t):
                t = t.clone()
                t[t.shape[0] // 2:] = 0
                return t
            out = _map(out, halve)
        elif self._fault == "altered":
            def swap(t):
                t = t.clone()
                t[0] = t[1]
                return t
            out = (out[0], *map(swap, out[1:])) if isinstance(out, tuple) else swap(out)
        return out
