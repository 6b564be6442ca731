"""Kernel 4 (``csrc/blend_bwd.cu``): its least time for the step's
counted work over its device time a step (%)."""
from benchmark.readers import roofline_pct


def read(r):
    return roofline_pct(r, "steps", "blend_bwd")
