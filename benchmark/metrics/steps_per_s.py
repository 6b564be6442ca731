"""Training steps over the time from the window's first issue to its
closing synchronize, a second."""
from benchmark.readers import rate


def read(r):
    return rate(r, "steps")
