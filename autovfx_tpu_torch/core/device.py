"""The device the package's loaders and constructors put their tensors on.

Their ``device`` defaults to ``"cuda"``: a scene loaded or made without
naming a device lands on the card, where the kernels run.  Without a
card such a call raises; it never falls back to the CPU, whose plain
path is for the tests and is asked for with ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device
    and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to "
            "put the tensors on the CPU")
    return dev
