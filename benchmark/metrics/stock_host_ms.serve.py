"""Host self time per batch of the ``stock`` spans (the seg stem, the blocks
run as modules and the head; HRNet's backbone and head, the stock normalize,
the heatmap decode): their durations less what their child spans cover, in
the traced slice (``program_spans``)."""

import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.host_ms("stock")
