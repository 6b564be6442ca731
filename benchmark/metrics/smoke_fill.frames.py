"""The live smoke splats over the smoke set's slots (%): the program's
``smoke.splats`` (device) over ``smoke.slots`` (host).  The rest are
masked splats that kernel 1 still reads."""
from benchmark.spans import share_pct


def read(r):
    return share_pct(r, "frames", "smoke.splats", "smoke.slots")
