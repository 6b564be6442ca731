"""Melting and incineration of surfel and splat objects.

Counterpart of ``autovfx_tpu/render/melt.py``: melting as a deformation
schedule (points sink toward the ground, spread radially and merge into
a puddle), incineration as a burn to char with an opacity fade.  Both
are functions of (object, progress in [0, 1]) applied before shading.
The surfel functions are numpy, as in the JAX package; the splat
functions work on a ``Gaussians`` on its own device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core.quaternion import quat_to_rotmat
from autovfx_tpu_torch.core.sh import C0, rgb_to_sh

CHAR = (0.05, 0.04, 0.035)  # the burned color


def melt_surfels(
    points: np.ndarray,
    normals: np.ndarray,
    progress: float,
    ground_z: Optional[float] = None,
    spread: float = 1.6,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Deform object-local surfels toward a puddle: (points, normals,
    radius_scale); progress 0 = intact, 1 = a fully melted puddle."""
    p = float(np.clip(progress, 0.0, 1.0))
    pts = np.asarray(points, np.float32).copy()
    if ground_z is None:
        ground_z = float(pts[:, 2].min())
    h = pts[:, 2] - ground_z
    # height collapses, the base spreads; higher points collapse first
    squash = 1.0 - p * (0.85 + 0.1 * (h / max(h.max(), 1e-6)))
    pts[:, 2] = ground_z + h * np.clip(squash, 0.05, 1.0)
    center_xy = pts[:, :2].mean(0)
    pts[:, :2] = center_xy + (pts[:, :2] - center_xy) * (
        1.0 + (spread - 1.0) * p)
    # normals flatten toward +z as the surface becomes a puddle
    n = np.asarray(normals, np.float32).copy()
    up = np.array([0, 0, 1], np.float32)
    n = (1 - p) * n + p * up[None]
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    radius_scale = 1.0 + 0.6 * p  # surfels widen to close gaps
    return pts, n, radius_scale


def melt_gaussians(g, progress: float, ground_z: Optional[float] = None,
                   spread: float = 1.6):
    """Melt a splat object by ``melt_surfels``' deformation field: the
    centers move with it, and each splat's scales follow the field's
    diagonal Jacobian diag(sxy, sxy, sz) rotated into the splat's frame,
    f_j = sqrt(Σ_k J_kk² R_kj²).  Without ``ground_z`` the lowest center
    is the ground (read back once)."""
    p = float(np.clip(progress, 0.0, 1.0))
    if p == 0.0:
        return g
    xyz = g.xyz
    if ground_z is None:
        ground_z = float(torch.min(xyz[:, 2]))
    h = xyz[:, 2] - ground_z
    h_max = torch.clamp(torch.max(h), min=1e-6)
    squash = torch.clamp(1.0 - p * (0.85 + 0.1 * (h / h_max)), 0.05, 1.0)
    z_new = ground_z + h * squash
    center_xy = torch.mean(xyz[:, :2], dim=0)
    sxy = 1.0 + (spread - 1.0) * p
    xy_new = center_xy + (xyz[:, :2] - center_xy) * sxy
    rot = quat_to_rotmat(g.rotations)  # (N, 3, 3), columns the local axes
    j2 = torch.stack([torch.full_like(squash, sxy**2),
                      torch.full_like(squash, sxy**2), squash**2], dim=-1)
    f = torch.sqrt(torch.clamp(torch.einsum("nk,nkj->nj", j2, rot**2),
                               min=1e-12))
    return dataclasses.replace(
        g, xyz=torch.cat([xy_new, z_new[:, None]], dim=-1),
        log_scales=g.log_scales + torch.log(f))


def incinerate_gaussians(g, progress: float):
    """Burn to black and fade to ash, on a splat object: the DC band
    darkens toward char, the higher bands fade, and past 70 % progress the
    opacity ramps down (``incinerate_colors``' schedule)."""
    p = float(np.clip(progress, 0.0, 1.0))
    if p == 0.0:
        return g
    char = torch.tensor(CHAR, device=g.sh_dc.device)
    rgb = g.sh_dc * C0 + 0.5  # the DC band's color
    burned = (1 - 0.9 * p) * rgb + 0.9 * p * char[None]
    op_scale = 1.0 if p < 0.7 else max(1.0 - (p - 0.7) / 0.3, 1e-4)
    # sigmoid(x + log s) ≈ s·sigmoid(x) for small s
    return dataclasses.replace(
        g, sh_dc=rgb_to_sh(burned), sh_rest=g.sh_rest * (1.0 - 0.9 * p),
        opacity_logit=g.opacity_logit + float(np.log(op_scale)))


def incinerate_colors(colors, progress: float) -> tuple:
    """Burn to black and fade to ash: (colors as a float32 tensor on the
    colors' device, opacity scale)."""
    p = float(np.clip(progress, 0.0, 1.0))
    c = torch.as_tensor(colors, dtype=torch.float32)
    char = torch.tensor(CHAR, device=c.device)
    burned = (1 - 0.9 * p) * c + 0.9 * p * char[None]
    opacity_scale = 1.0 if p < 0.7 else float(1.0 - (p - 0.7) / 0.3)
    return burned, max(opacity_scale, 0.0)


def effect_progress(frame_idx: int, start_frame: int,
                    end_frame: Optional[int], total_frames: int) -> float:
    """Linear progress of an event over its window (1-based frames)."""
    f0 = start_frame - 1
    f1 = (end_frame - 1) if end_frame else total_frames
    if frame_idx < f0:
        return 0.0
    return min((frame_idx - f0) / max(f1 - f0, 1), 1.0)
