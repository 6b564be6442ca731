"""SuGaR's density field on the card: the wrappers of
``csrc/density_field.cu``, forward and backward, as one autograd
function.

``density_field`` takes CUDA tensors only; ``sugar/density.py`` sends a
CPU tensor to its elementwise twin instead.  The wrappers check device,
dtype, shape and contiguity, then launch or raise.  The splats' centres,
opacities and inverse-covariance entries are packed once a call into the
kernels' (N, 12) records; the gradient in them comes back as views of
one (N, 12) buffer, and autograd carries it on to the splat parameters.
"""
from __future__ import annotations

import torch

from autovfx_tpu_torch.ops import _build
from autovfx_tpu_torch.ops._build import check_tensor
from autovfx_tpu_torch.utils import trace

RECORD = 12  # floats a splat: centre 3, opacity, six entries, two of padding


def pack_table(centers: torch.Tensor, opacity: torch.Tensor,
               entries: torch.Tensor) -> torch.Tensor:
    """(N, 12) records: centre, opacity, a00 a01 a02 a11 a12 a22, 0, 0."""
    pad = centers.new_zeros((centers.shape[0], RECORD - 10))
    return torch.cat([centers, opacity[:, None], entries, pad], dim=1)


def _check_inputs(points, nbrs, table) -> None:
    p, k = nbrs.shape
    check_tensor(points, "points", torch.float32, (p, 3))
    check_tensor(nbrs, "neighbors", torch.int32, (p, k))
    check_tensor(table, "table", torch.float32, (table.shape[0], RECORD))
    if nbrs.device != points.device or table.device != points.device:
        raise ValueError("points, neighbors and the splats must be on one "
                         "device")
    if table.data_ptr() % 16:
        raise ValueError("the splat table must be 16-byte aligned")


def field_fwd_kernel(points, nbrs, table) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,) density and (P, 3) gradient at ``points`` from their int32
    neighbour rows over the (N, 12) ``table``."""
    _check_inputs(points, nbrs, table)
    p, k = nbrs.shape
    density = points.new_empty((p,))
    gradient = points.new_empty((p, 3))
    lib = _build.load_library()
    with torch.cuda.device(points.device):
        err = lib.density_fwd(p, k, points.data_ptr(), nbrs.data_ptr(),
                              table.data_ptr(), density.data_ptr(),
                              gradient.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "density_fwd")
    trace.count("launch.density_fwd")
    return density, gradient


def field_bwd_kernel(points, nbrs, table, g_dens, g_grad,
                     want_points: bool = True):
    """(dL/dpoints (P, 3) or None, dL/dtable (N, 12)) from the cotangents
    of the density (P,) and the gradient (P, 3), either of them None."""
    _check_inputs(points, nbrs, table)
    p = nbrs.shape[0]
    if g_dens is not None:
        check_tensor(g_dens, "g_density", torch.float32, (p,))
    if g_grad is not None:
        check_tensor(g_grad, "g_gradient", torch.float32, (p, 3))
    d_points = points.new_empty((p, 3)) if want_points else None
    d_table = torch.zeros_like(table)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load_library()
    with torch.cuda.device(points.device):
        err = lib.density_bwd(p, nbrs.shape[1], points.data_ptr(),
                              nbrs.data_ptr(), table.data_ptr(), ptr(g_dens),
                              ptr(g_grad), ptr(d_points), d_table.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "density_bwd")
    trace.count("launch.density_bwd")
    return d_points, d_table


class DensityFieldFn(torch.autograd.Function):
    """``apply(points, neighbors, centers, opacity, entries)`` returns
    ``(density, gradient)``; the int32 neighbour rows are not
    differentiated."""

    @staticmethod
    def forward(ctx, points, neighbors, centers, opacity, entries):
        table = pack_table(centers, opacity, entries)
        out = field_fwd_kernel(points, neighbors, table)
        ctx.save_for_backward(points, neighbors, table)
        ctx.set_materialize_grads(False)  # an unused output sends None
        return out

    @staticmethod
    def backward(ctx, g_dens, g_grad):
        points, neighbors, table = ctx.saved_tensors
        if g_dens is None and g_grad is None:
            return None, None, None, None, None
        d_points, d_table = field_bwd_kernel(
            points, neighbors, table,
            None if g_dens is None else g_dens.contiguous(),
            None if g_grad is None else g_grad.contiguous(),
            want_points=ctx.needs_input_grad[0])
        return (d_points, None, d_table[:, 0:3], d_table[:, 3],
                d_table[:, 4:10])


def density_field(points: torch.Tensor, neighbors: torch.Tensor,
                  centers: torch.Tensor, opacity: torch.Tensor,
                  entries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,) density and (P, 3) gradient, differentiable in the points
    and the splats' centres (N, 3), opacities (N,) and inverse-covariance
    entries (N, 6); int64 neighbour rows are converted to int32 once
    here, for both passes."""
    if neighbors.dtype == torch.int64:
        neighbors = neighbors.to(torch.int32)
    return DensityFieldFn.apply(points, neighbors, centers, opacity, entries)
