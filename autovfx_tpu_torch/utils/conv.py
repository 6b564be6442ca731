"""2-D convolutions in IEEE float32, whatever the global TF32 flags say.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), a 10-bit mantissa that
the package's parity budgets do not allow.  ``conv2d`` turns TF32 off
for its own forward and backward only (autograd's convolution backward
reads the flag when it runs, so the backward is done here too) and puts
the caller's setting back.  On the CPU the flag changes nothing.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_float32():
    """cuDNN convolutions in float32 inside the block."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        with ieee_float32():
            return F.conv2d(x, w, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        with ieee_float32():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, gy,
                                                padding=ctx.padding)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, gy,
                                                 padding=ctx.padding)
        return gx, gw, None


def conv2d(x: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    """``F.conv2d(x, w, padding=padding)`` (no bias, stride 1) in IEEE
    float32, forward and backward."""
    return _Conv2d.apply(x, w, padding)
