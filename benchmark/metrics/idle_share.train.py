"""The traced window's share (%) in which no device record ran:
1 - the union of the profiler's device records over the window."""
from benchmark.readers import idle_pct


def read(r):
    return idle_pct(r, "steps")
