"""Host self time per batch of the ``kernels`` spans (``kernel.<name>``:
each hand-written kernel's wrapper on its CUDA path): their durations less
what their child spans cover, in the traced slice (``program_spans``)."""

import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.host_ms("kernels")
