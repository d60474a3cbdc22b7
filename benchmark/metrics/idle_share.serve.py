"""The device's idle share of the traced slice (``core.idle_share``)."""

from core import idle_share


def read(run):
    return idle_share(run)
