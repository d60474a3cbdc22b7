"""Host time per batch inside the entry's call, until it returns (the
benchmark's own span around the call), the mean over the traced slice's
batches. The profiler records device activity only, so the host's turn is
not slowed by it."""


def read(run):
    items = run.trace.items if run.trace else []
    return sum(i.t_ret - i.t_hand for i in items) * 1e3 / len(items) if items else None
