"""Kernel 3 (``csrc/blend_fwd.cu``): its least time for the frame's
counted work over its device time a frame (%)."""
from benchmark.readers import roofline_pct


def read(r):
    return roofline_pct(r, "frames", "blend_fwd")
