"""The duplicates the views asked for over the budget slots sorted (%):
the program's ``raster.dups`` (device) over ``raster.slots`` (host)."""
from benchmark.spans import share_pct


def read(r):
    return share_pct(r, "frames", "raster.dups", "raster.slots")
