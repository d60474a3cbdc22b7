"""``fused_tail_chain``'s share of its roofline (``core.roofline``), its work counted
by ``work/fused_tail_chain.py``."""

from core import roofline


def read(run):
    return roofline(run, "work/fused_tail_chain.py")
