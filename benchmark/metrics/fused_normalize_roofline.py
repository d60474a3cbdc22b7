"""``fused_normalize``'s share of its roofline (``core.roofline``), its work counted
by ``work/fused_normalize.py``."""

from core import roofline


def read(run):
    return roofline(run, "work/fused_normalize.py")
