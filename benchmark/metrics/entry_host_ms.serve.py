"""Host self time per batch of the ``entry`` spans (``seg.predict``,
``seg.upload``, ``pose.heatmaps``, ``pose.upload``, ``pose.decode``): their
durations less what their child spans cover, in the traced slice
(``program_spans``)."""

import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.host_ms("entry")
