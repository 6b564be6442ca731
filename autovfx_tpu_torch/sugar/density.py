"""SuGaR's density field over the Gaussian mixture.

Counterpart of ``autovfx_tpu/sugar/density.py`` (itself
``sugar_scene/sugar_model.py``'s ``compute_density`` :1216-1239,
``get_beta`` :1043-1117 and the SDF estimate of ``get_field_values``
:1118): density(x) = Σ_{j ∈ kNN(x)} σ_j · exp(-½ (x-μ_j)ᵀ Σ_j⁻¹ (x-μ_j)).

The neighbour lists come from the Morton-window KNN (``ops/knn``).  The
field is evaluated ``CHUNK`` points at a time, as the JAX package's
``lax.map`` does: at a million samples with 16 neighbours each, one
gather of the inverse covariances is 400 MB.  Sampling draws from an
explicit ``torch.Generator``, or takes the draws ``(idx, eps)`` from
the caller.

The 3×3 algebra is written out as elementwise products and sums: a
chunk gathers each neighbour's centre and the six unique entries of its
symmetric inverse covariance as (chunk, k) planes, and A·d and dᵀA·d
are sums of plane products.  Batched 1×3 by 3×3 matrix products of
these shapes run at a tiny fraction of the device; elementwise passes
are bound by memory traffic, and autograd derives the backward from the
same forward.

That elementwise form is the plain twin: the CPU runs it, ``chunk``
points at a time.  On CUDA tensors ``density_field`` runs the hand
kernels of ``ops/density_cuda`` instead (one forward for the density
and its gradient together, one backward that recomputes each pair and
scatters the splats' gradients), whole, with no chunks.
"""
from __future__ import annotations

from typing import Optional

import torch

from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.core.quaternion import quat_to_rotmat
from autovfx_tpu_torch.ops import density_cuda
from autovfx_tpu_torch.ops.knn import knn_indices
from autovfx_tpu_torch.utils.gather import take

CHUNK = 1 << 18  # query points per evaluation


def gaussian_inverse_covariance(g: Gaussians) -> torch.Tensor:
    """(N, 3, 3) inverse world covariance R S^-2 R^T:
    A_ab = Σ_j R_aj R_bj / s_j²."""
    rot = quat_to_rotmat(g.rotations)
    inv_s2 = 1.0 / torch.clamp(g.scales**2, min=1e-12)
    return torch.sum(rot[:, :, None, :] * rot[:, None, :, :]
                     * inv_s2[:, None, None, :], dim=-1)


def reset_neighbors(g: Gaussians, k: int = 16) -> torch.Tensor:
    """(N, k) neighbour indices among the active Gaussians."""
    with torch.no_grad():
        idx, _ = knn_indices(g.xyz.detach(), g.active, k=k)
    return idx


def _inverse_covariance_entries(g: Gaussians) -> torch.Tensor:
    """(N, 6) unique entries of the inverse covariances: a00 a01 a02 a11
    a12 a22."""
    a = gaussian_inverse_covariance(g)
    return torch.cat([a[:, 0, :], a[:, 1, 1:], a[:, 2, 2:]], dim=1)


def _splats(g: Gaussians):
    """What the field reads of the Gaussians: centres (N, 3), opacities
    (N,) and inverse-covariance entries (N, 6)."""
    return g.xyz, g.opacity, _inverse_covariance_entries(g)


def _dot3(a, b) -> torch.Tensor:
    """Σ_i a_i b_i over three planes."""
    return torch.addcmul(torch.addcmul(a[0] * b[0], a[1], b[1]), a[2], b[2])


def _field_pairs(points, nbrs, centers, entries, opacity):
    """A chunk's (point, neighbour) pairs as (C, k) planes: A·d with
    d = x − μ (three planes) and the weight σ·exp(-½ dᵀA d)."""
    flat = nbrs.reshape(-1)
    mu = centers.index_select(1, flat).view(3, *nbrs.shape)
    a00, a01, a02, a11, a12, a22 = entries.index_select(1, flat).view(
        6, *nbrs.shape).unbind(0)
    # contiguous, so that d's planes are too: the difference takes the
    # layout of its first operand
    d = (points.T.contiguous()[:, :, None] - mu).unbind(0)
    icd = (_dot3((a00, a01, a02), d), _dot3((a01, a11, a12), d),
           _dot3((a02, a12, a22), d))
    return icd, take(opacity, nbrs) * torch.exp(-0.5 * _dot3(d, icd))


def field_twin(points, nbrs, centers, opacity, entries, chunk: int = CHUNK
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of ``ops/density_cuda.density_field``, on any
    device: (P,) density and (P, 3) gradient, ``chunk`` points at a
    time, differentiated by autograd.  The centres (N, 3) and entries
    (N, 6) are turned to a row per value, so that a gather along the
    rows gives a (chunk, k) plane per value."""
    tables = (centers.T, entries.T.contiguous(), opacity)
    dens, grad = [], []
    for s in range(0, points.shape[0], chunk):
        icd, w = _field_pairs(points[s:s + chunk], nbrs[s:s + chunk], *tables)
        dens.append(torch.sum(w, dim=-1))
        grad.append(-torch.stack([torch.sum(w * c, dim=-1) for c in icd],
                                 dim=-1))
    if not dens:
        return points.new_zeros((0,)), points.new_zeros((0, 3))
    return torch.cat(dens), torch.cat(grad)


def density_field(
    points: torch.Tensor,  # (P, 3) query points
    point_neighbors: torch.Tensor,  # (P, k) Gaussian indices per point
    g: Gaussians,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,) density and (P, 3) analytic gradient from one evaluation of
    the (point, neighbour) pairs: the hand kernels on CUDA tensors, whole
    (they keep no per-pair planes, so ``chunk`` does not apply), the twin
    ``chunk`` points at a time on the CPU."""
    if points.is_cuda:
        return density_cuda.density_field(points, point_neighbors,
                                          *_splats(g))
    return field_twin(points, point_neighbors, *_splats(g), chunk)


def compute_density(
    points: torch.Tensor,  # (P, 3) query points
    point_neighbors: torch.Tensor,  # (P, k) Gaussian indices per point
    g: Gaussians,
    chunk: int = CHUNK,
) -> torch.Tensor:
    """(P,) density at the query points from their k nearest Gaussians
    (``chunk`` as in ``density_field``: the CPU twin's only)."""
    return density_field(points, point_neighbors, g, chunk)[0]


def compute_beta(
    points: torch.Tensor,
    point_neighbors: Optional[torch.Tensor],
    g: Gaussians,
    mode: str = "average",
    log_beta: Optional[torch.Tensor] = None,
    opacity_min_clamp: float = 1e-16,
) -> torch.Tensor:
    """β(x) per query point: ``average`` is the mean min-scale of the k
    nearest Gaussians, ``weighted_average`` their opacity-weighted mean,
    ``learnable`` one trained scalar exp(``log_beta``) for every point."""
    if mode == "learnable":
        if log_beta is None:
            raise ValueError("learnable beta mode needs log_beta")
        return torch.exp(torch.as_tensor(log_beta)).expand(points.shape[:1])
    min_scale = torch.amin(g.scales, dim=-1)
    if mode == "weighted_average":
        op = take(g.opacity, point_neighbors)
        w = op / torch.clamp(torch.sum(op, dim=-1, keepdim=True),
                             min=opacity_min_clamp)
        return torch.clamp(
            torch.sum(w * take(min_scale, point_neighbors), dim=-1), min=1e-8)
    return torch.mean(take(min_scale, point_neighbors), dim=-1)


def density_to_sdf(density: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SDF estimate s = β·sqrt(-2 ln(clamp(d)))."""
    d = torch.clamp(density, 1e-12, 1.0 - 1e-7)
    return beta * torch.sqrt(-2.0 * torch.log(d))


def density_gradient(
    points: torch.Tensor, point_neighbors: torch.Tensor, g: Gaussians,
    chunk: int = CHUNK,
) -> torch.Tensor:
    """(P, 3) analytic ∇density (the level set's normals; ``chunk`` as
    in ``density_field``)."""
    return density_field(points, point_neighbors, g, chunk)[1]


def draw_samples(
    g: Gaussians,
    generator: torch.Generator,
    num_samples: int,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The draws of ``sample_points_in_gaussians``: (S,) Gaussian indices
    in proportion to the active mask (times ``mask``; every other slot
    weighs 1e-12, as the JAX package's log-weights do) and (S, 3)
    standard normals, both from ``generator`` on its device and moved to
    the Gaussians'."""
    dev = g.xyz.device
    gdev = generator.device
    w = g.active.to(torch.float32)
    if mask is not None:
        w = w * mask.to(torch.float32)
    w = torch.clamp(w, min=1e-12).to(gdev)
    idx = torch.multinomial(w, num_samples, replacement=True,
                            generator=generator)
    eps = torch.randn((num_samples, 3), generator=generator, device=gdev)
    return idx.to(dev), eps.to(dev)


def sample_points_in_gaussians(
    g: Gaussians,
    generator: Optional[torch.Generator],
    num_samples: int,
    mask: Optional[torch.Tensor] = None,
    draws: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Points of the mixture (``sample_points_in_gaussians``,
    sugar_model.py:757): x = μ_i + R_i (s_i ⊙ eps) for the draws ``(idx,
    eps)`` (made by ``draw_samples`` when not given).  Differentiable in
    the Gaussians.  Returns (points (S, 3), source index (S,))."""
    if draws is None:
        draws = draw_samples(g, generator, num_samples, mask)
    idx, eps = draws
    rot = quat_to_rotmat(take(g.rotations, idx))
    offset = torch.sum(rot * (take(g.scales, idx) * eps)[:, None, :], dim=-1)
    return take(g.xyz, idx) + offset, idx
