"""Stream ms a step in the photometric loss forward, L1 and D-SSIM (the
program's ``step.loss`` span)."""
from benchmark.spans import stream_ms


def read(r):
    return stream_ms(r, "steps", "step.loss")
