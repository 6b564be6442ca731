"""The host's mean milliseconds from a call to its return, before the
synchronize, in the traced window (the benchmark's spans round the
entry)."""
from benchmark.readers import issue_ms


def read(r):
    return issue_ms(r, "frames")
