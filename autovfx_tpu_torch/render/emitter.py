"""Indoor-scene emitter lighting: an emitter mesh as area-weighted point
lights.

Counterpart of ``autovfx_tpu/render/emitter.py``.  Inserted-object
surfels receive the emitter's direct Lambertian irradiance
Σ L·A·max(n·ω, 0)·|n_e·ω| / (π r²) in one (S, K) pass; occlusion is the
shadow pass's, as for every other light.

Not ported: ``load_emitter``, which reads the mesh through the edit
layer's mesh IO (queue 1 slice 7 of ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class EmitterLights(NamedTuple):
    points: torch.Tensor  # (K, 3) sample positions
    normals: torch.Tensor  # (K, 3) emitter surface normals
    radiance: torch.Tensor  # (K, 3) emitted radiance (strength · color)
    areas: torch.Tensor  # (K,) per-sample area


def load_emitter(mesh_path: str, *args, **kwargs) -> EmitterLights:
    raise NotImplementedError(
        "load_emitter reads the emitter mesh through the edit layer's mesh "
        "IO, which is queue 1 slice 7 of ROADMAP.md and not ported yet; "
        "build EmitterLights from the mesh's samples directly")


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
