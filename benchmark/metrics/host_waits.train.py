"""Synchronizing CUDA calls a step inside the program's ``step`` span:
its ``host_waits`` counter."""
from benchmark.spans import per_call


def read(r):
    return per_call(r, "steps", "host_waits")
