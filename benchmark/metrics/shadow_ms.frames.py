"""Stream ms a frame in the edited frame's hull shadow (the program's
``frame.shadow`` span: the hull planes, the object weight and the shadow
ratio map)."""
from benchmark.spans import stream_ms


def read(r):
    return stream_ms(r, "frames", "frame.shadow")
