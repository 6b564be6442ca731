"""Stream ms a frame in the fire pass (the program's ``frame.fire``
span: the fire splats' own render; the composite adds it outside)."""
from benchmark.spans import stream_ms


def read(r):
    return stream_ms(r, "frames", "frame.fire")
