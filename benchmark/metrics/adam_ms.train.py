"""Stream ms a step in Adam and the densify statistics (the program's
``step.adam`` span)."""
from benchmark.spans import stream_ms


def read(r):
    return stream_ms(r, "steps", "step.adam")
