"""Synchronizing CUDA calls a frame inside the program's root spans
(``frame``, or ``raster`` called alone): its ``host_waits`` counter."""
from benchmark.spans import per_call


def read(r):
    return per_call(r, "frames", "host_waits")
