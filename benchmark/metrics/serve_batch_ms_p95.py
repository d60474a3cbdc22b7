"""The 95th percentile, over every batch complete in the window, of the
time from handing its host tensor to the entry to its outputs' completion
on the card (the card's own time of an event behind the batch, on the
host's clock: ``core.CardClock``)."""

from core import quantile


def read(run):
    ms = [(i.t_done - i.t_hand) * 1e3 for i in run.window.done()]
    return quantile(ms, 95) if ms else None
