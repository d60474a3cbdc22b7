"""Device idle time per batch that falls inside the self time of the
``entry`` spans (``seg.predict``, ``seg.upload``, ``pose.heatmaps``,
``pose.upload``, ``pose.decode``), each idle gap of the traced slice split
by overlap (``program_spans``)."""

import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.idle_ms("entry")
