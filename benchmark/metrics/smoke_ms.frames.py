"""Stream ms a frame in the smoke splats' build (the program's
``frame.smoke`` span: ``render/clip.smoke_gaussians``, the display
noise, the densest-cell sort and the smoke and fire sets)."""
from benchmark.spans import stream_ms


def read(r):
    return stream_ms(r, "frames", "frame.smoke")
