"""Indoor-scene emitter lighting: an emitter mesh as area-weighted point
lights.

Counterpart of ``autovfx_tpu/render/emitter.py``.  Inserted-object
surfels receive the emitter's direct Lambertian irradiance
Σ L·A·max(n·ω, 0)·|n_e·ω| / (π r²) in one (S, K) pass; occlusion is the
shadow pass's, as for every other light.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices


class EmitterLights(NamedTuple):
    points: torch.Tensor  # (K, 3) sample positions
    normals: torch.Tensor  # (K, 3) emitter surface normals
    radiance: torch.Tensor  # (K, 3) emitted radiance (strength · color)
    areas: torch.Tensor  # (K,) per-sample area


def load_emitter(
    mesh_path: str,
    num_samples: int = 256,
    strength: float = 10.0,
    color=(1.0, 1.0, 1.0),
    seed: int = 0,
    device=devices.DEFAULT,
) -> EmitterLights:
    """Sample an emitter mesh into ``num_samples`` area-weighted point
    lights on ``device`` (numpy's draws for ``seed``, as the
    reference's)."""
    from autovfx_tpu_torch.edit import mesh_io

    device = devices.resolve(device)
    mesh = mesh_io.load_mesh(mesh_path)
    v = np.asarray(mesh.vertices, np.float32)
    f = np.asarray(mesh.faces)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cross = np.cross(b - a, c - a)
    tri_area = 0.5 * np.linalg.norm(cross, axis=-1)
    total = max(float(tri_area.sum()), 1e-12)
    rng = np.random.RandomState(seed)
    ti = rng.choice(len(f), size=num_samples, p=tri_area / total)
    u = rng.rand(num_samples, 1).astype(np.float32)
    w = rng.rand(num_samples, 1).astype(np.float32)
    flip = (u + w) > 1.0
    u = np.where(flip, 1.0 - u, u)
    w = np.where(flip, 1.0 - w, w)
    pts = a[ti] + u * (b[ti] - a[ti]) + w * (c[ti] - a[ti])
    nrm = cross[ti] / np.maximum(
        np.linalg.norm(cross[ti], axis=-1, keepdims=True), 1e-12)
    rad = np.tile(np.asarray(color, np.float32)[None] * strength,
                  (num_samples, 1))
    areas = np.full(num_samples, total / num_samples, np.float32)
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    return EmitterLights(points=t(pts), normals=t(nrm), radiance=t(rad),
                         areas=t(areas))


def emitter_irradiance(
    pts: torch.Tensor,  # (S, 3) shaded surface points
    nrms: torch.Tensor,  # (S, 3) unit normals
    lights: EmitterLights,
    eps: float = 1e-3,
) -> torch.Tensor:
    """(S, 3) direct irradiance from two-sided emitter samples."""
    d = lights.points[None, :, :] - pts[:, None, :]  # (S, K, 3)
    r2 = torch.sum(d * d, dim=-1)
    inv_r = torch.rsqrt(torch.clamp(r2, min=eps))
    wdir = d * inv_r[..., None]
    cos_s = torch.clamp(torch.sum(nrms[:, None, :] * wdir, -1), min=0.0)
    cos_e = torch.abs(torch.sum(lights.normals[None] * wdir, -1))
    g = cos_s * cos_e / (math.pi * torch.clamp(r2, min=eps))
    return torch.einsum("sk,kc->sc", g * lights.areas[None, :],
                        lights.radiance)
