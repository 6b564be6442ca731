"""The frame's counted work (kernels 1-3) at the chip's peaks over the
frame's time in the traced window (%)."""
from benchmark.readers import mfu_pct


def read(r):
    return mfu_pct(r, "frames")
