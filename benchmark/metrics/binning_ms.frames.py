"""Stream ms a frame in the tile binning (the program's
``raster.binning`` span: the cumsum, kernel 2, the stable sort and the
tile ranges)."""
from benchmark.spans import stream_ms


def read(r):
    return stream_ms(r, "frames", "raster.binning")
