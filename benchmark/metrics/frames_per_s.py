"""Frames completed over the whole window, a second (closed loop)."""
from benchmark.readers import rate


def read(r):
    return rate(r, "frames")
