"""Screened Poisson surface reconstruction, solved spectrally.

Counterpart of ``autovfx_tpu/sugar/poisson.py`` (in place of
``sugar_extractors/coarse_mesh.py:398-409``'s Open3D Poisson at depth 10
and its density-quantile prune :441-449): the oriented level-set samples
are splatted trilinearly into a normal field V on a regular grid, the
indicator χ solves (∇² − λ)χ = ∇·V on the padded periodic grid with one
3-D FFT, the isovalue is the mean of χ at the samples, and the surface
is meshed by marching tetrahedra on the host.

The splat is ``index_put_(accumulate=True)``: on the card its atomics
add in no fixed order, so a card mesh matches a CPU mesh by vertex
distance, not bit for bit.  The FFTs are ``torch.fft`` (cuFFT on the
card), where the JAX package has XLA's.
"""
from __future__ import annotations

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.sugar.decimate import (
    density_quantile_prune,
    remove_small_components,
)
from autovfx_tpu_torch.sugar.marching import marching_tetrahedra


def _trilinear_scatter(grid_shape, idx_f: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Scatter-add ``values`` (P, C) at fractional grid indices (P, 3)."""
    base = torch.floor(idx_f).to(torch.int64)
    frac = idx_f - base
    out = torch.zeros(tuple(grid_shape) + (values.shape[-1],),
                      dtype=torch.float32, device=idx_f.device)
    r = torch.as_tensor(grid_shape, dtype=torch.int64, device=idx_f.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                cell = base + torch.tensor([dx, dy, dz], device=base.device)
                ok = ((cell >= 0) & (cell < r)).all(dim=1)
                cell = torch.minimum(torch.clamp(cell, min=0), r - 1)
                w = torch.where(ok, w, torch.zeros_like(w))
                out.index_put_((cell[:, 0], cell[:, 1], cell[:, 2]),
                               w[:, None] * values, accumulate=True)
    return out


def _solve(points: torch.Tensor, normals: torch.Tensor, lo: np.ndarray,
           spacing: np.ndarray, ext: np.ndarray, res: int, screening: float):
    """(χ, isovalue, sample occupancy) on the device of ``points``."""
    dev = points.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    idx_f = (points - f32(lo)) / f32(spacing)
    V = _trilinear_scatter((res, res, res), idx_f, normals)
    occ = _trilinear_scatter((res, res, res), idx_f,
                             torch.ones_like(points[:, :1]))[..., 0]
    # spectral divergence and screened inverse Laplacian
    k = torch.fft.fftfreq(res, device=dev) * 2.0 * np.pi
    kx = (k / float(spacing[0])).reshape(res, 1, 1)
    ky = (k / float(spacing[1])).reshape(1, res, 1)
    kz = (k / float(spacing[2])).reshape(1, 1, res)
    div = 1j * (kx * torch.fft.fftn(V[..., 0]) + ky * torch.fft.fftn(V[..., 1])
                + kz * torch.fft.fftn(V[..., 2]))
    k2 = kx**2 + ky**2 + kz**2
    lam = float(np.float32(screening) * (np.float32(2.0 * np.pi)
                                         / ext.max()) ** 2)
    # the normal field's Gaussian prefilter (the octree's B-spline),
    # σ = 1.5 voxels
    sigma = 1.5 * float(np.mean(spacing))
    smooth = torch.exp(-0.5 * k2 * sigma * sigma)
    chi = torch.real(torch.fft.ifftn(smooth * div / (-k2 - lam)))
    # the isovalue: the mean of χ at the samples' nearest grid points
    ci = torch.clamp(torch.round(idx_f).to(torch.int64), 0, res - 1)
    iso = torch.mean(chi[ci[:, 0], ci[:, 1], ci[:, 2]])
    return chi, iso, occ


def _prune_unsupported(verts, faces, occ, lo, spacing, res: int,
                       density_quantile: float):
    """Drop vertices with no sample within a few voxels, then the lowest
    ``density_quantile`` of sample support (the Open3D density prune's
    job)."""
    cell = np.clip(((verts - lo[None]) / spacing[None]).astype(np.int64),
                   0, res - 1)
    occ_s = occ  # the sample support, dilated 3 voxels
    for _ in range(3):
        for ax in (0, 1, 2):
            occ_s = np.maximum(occ_s, np.maximum(np.roll(occ_s, 1, axis=ax),
                                                 np.roll(occ_s, -1, axis=ax)))
    dens = occ_s[cell[:, 0], cell[:, 1], cell[:, 2]]
    keep = dens > 0.05
    new_id = np.cumsum(keep) - 1
    face_ok = keep[faces].all(axis=1)
    verts, faces = verts[keep], new_id[faces[face_ok]]
    if len(verts):
        verts, faces = density_quantile_prune(verts, faces, dens[keep],
                                              density_quantile)
    return verts, faces


def poisson_reconstruct(
    points,
    normals,
    bbox_min,
    bbox_max,
    resolution: int = 192,
    screening: float = 8.0,
    pad: float = 0.15,
    density_quantile: float = 0.1,
    device=devices.DEFAULT,
):
    """(verts, faces) of the screened-Poisson indicator surface of the
    oriented samples (numpy arrays or tensors), solved on ``device``.

    ``screening`` is λ in units of the fundamental frequency²: it pins χ
    to 0 far from the data and closes the surface.  ``density_quantile``
    prunes the vertices with the least sample support."""
    device = devices.resolve(device)
    host = lambda a: (a.detach().cpu().numpy() if torch.is_tensor(a)
                      else np.asarray(a))
    bbox_min = np.asarray(bbox_min, np.float32)
    bbox_max = np.asarray(bbox_max, np.float32)
    span = bbox_max - bbox_min
    lo = bbox_min - pad * span
    hi = bbox_max + pad * span
    ext = hi - lo
    res = resolution
    spacing = ext / (res - 1)

    t = lambda a: torch.as_tensor(np.asarray(host(a), np.float32),
                                  device=device)
    chi, iso, occ = _solve(t(points), t(normals), lo, spacing, ext, res,
                           screening)
    chi, iso, occ = chi.cpu().numpy(), float(iso), occ.cpu().numpy()

    verts, faces = marching_tetrahedra(chi, iso, lo, spacing)
    if len(verts) and density_quantile:
        verts, faces = _prune_unsupported(verts, faces, occ, lo, spacing, res,
                                          density_quantile)
    if len(verts):
        verts, faces = remove_small_components(verts, faces)
    return verts, faces


def poisson_mesh_from_gaussians(
    g,
    cams,
    config=None,
    resolution: int = 192,
    every_nth: int = 3,
    level: float = 0.3,
    screening: float = 8.0,
):
    """Level-set cloud -> screened Poisson mesh (``coarse_mesh.py``'s
    pipeline), on the Gaussians' device; the box spans the 1st to 99th
    percentiles of the level-set samples."""
    from autovfx_tpu_torch.ops.rasterize import RasterConfig
    from autovfx_tpu_torch.sugar import extract_mesh as EM

    config = config or RasterConfig()
    pts, nrm = EM.extract_level_points(g, cams, config=config,
                                       every_nth=every_nth, level=level)
    pts, nrm = EM.remove_outliers(pts, nrm, device=g.xyz.device)
    lo = np.percentile(pts, 1, axis=0)
    hi = np.percentile(pts, 99, axis=0)
    # inward normals: the level-set normals face the cameras
    return poisson_reconstruct(pts, -nrm, lo, hi, resolution=resolution,
                               screening=screening, device=g.xyz.device)
