"""Stream ms a step in the backward (the program's ``step.backward``
span round ``torch.autograd.grad``: kernel 4, the preprocess backward,
SSIM's and, in SuGaR, the density field's)."""
from benchmark.spans import stream_ms


def read(r):
    return stream_ms(r, "steps", "step.backward")
