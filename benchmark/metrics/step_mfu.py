"""The step's counted work (kernels 1-4, the preprocess backward and
Adam) at the chip's peaks over the step's time in the traced
window (%)."""
from benchmark.readers import mfu_pct


def read(r):
    return mfu_pct(r, "steps")
