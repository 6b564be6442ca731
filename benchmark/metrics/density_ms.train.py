"""Stream ms a step in SuGaR's density field forward: samples, k-NN,
the density and normal terms (the program's ``sugar.density`` span)."""
from benchmark.spans import stream_ms


def read(r):
    return stream_ms(r, "steps", "sugar.density")
