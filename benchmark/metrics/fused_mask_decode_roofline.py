"""``fused_mask_decode``'s share of its roofline (``core.roofline``), its work counted
by ``work/fused_mask_decode.py``."""

from core import roofline


def read(run):
    return roofline(run, "work/fused_mask_decode.py")
