"""Stream ms a frame in the edited frame's object shading (the
program's ``frame.shading`` span: ``render/clip.shaded_object_gaussians``)."""
from benchmark.spans import stream_ms


def read(r):
    return stream_ms(r, "frames", "frame.shading")
