"""The port's kernel launches per batch: the ``launches`` of the root spans
(``ops/kernels/_build.py::count``'s running total, read at each span's
entry and exit) summed over the traced slice, over its batches
(``program_spans``)."""

import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.launches / spans.batches
