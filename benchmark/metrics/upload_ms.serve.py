"""Device time per batch of the copies from host to device in the traced
slice (the inputs' upload)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.items:
        return None
    us = tr.sum_us(lambda n: n.startswith("Memcpy HtoD"))
    return us * 1e-3 / len(tr.items) if us else None
