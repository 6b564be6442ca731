"""The 95th percentile of every frame's latency in the window, from its
issue to its synchronize, in milliseconds."""
from benchmark.readers import latency_p95_ms


def read(r):
    return latency_p95_ms(r)
