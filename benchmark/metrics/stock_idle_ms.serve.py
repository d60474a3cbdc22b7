"""Device idle time per batch that falls inside the self time of the
``stock`` spans (the seg stem, the blocks run as modules and the head;
HRNet's backbone and head, the stock normalize, the heatmap decode), each
idle gap of the traced slice split by overlap (``program_spans``)."""

import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.idle_ms("stock")
