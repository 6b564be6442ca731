"""Image-based lighting: SH-9 irradiance and split-sum GGX specular.

Counterpart of ``autovfx_tpu/render/ibl.py``: a Principled-BSDF-like
model lit by the HDR envmap, diffuse from the 9-coefficient irradiance
SH (Ramamoorthi-Hanrahan), specular from a prefiltered GGX stack and
the Karis/Lazarov analytic environment BRDF, or without the stack from
one mirror sample.  Mirrors may reflect scene content through one ray
cast against the scene mesh (``mirror_scene_reflection``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.quaternion import helper_axis
from autovfx_tpu_torch.ops.raymesh import ray_mesh_first_hit
from autovfx_tpu_torch.render.envmap import (
    direction_to_uv,
    sample_envmap,
    texel_directions,
)


class Material(NamedTuple):
    base_color: Optional[torch.Tensor] = None  # (3,)
    roughness: float = 0.5
    metallic: float = 0.0
    emission: Optional[torch.Tensor] = None


def _sh9_basis(x, y, z, lib):
    return lib.stack(
        [
            0.282095 * lib.ones_like(x),
            0.488603 * y,
            0.488603 * z,
            0.488603 * x,
            1.092548 * x * y,
            1.092548 * y * z,
            0.315392 * (3 * z * z - 1),
            1.092548 * x * z,
            0.546274 * (x * x - y * y),
        ],
        -1,
    )


def envmap_sh9(env: np.ndarray) -> np.ndarray:
    """Host-side: project an equirect map onto 9 SH coefficients, (9, 3)."""
    env = np.asarray(env, np.float32)
    h, w, _ = env.shape
    dirs = texel_directions(h, w)
    basis = _sh9_basis(dirs[..., 0], dirs[..., 1], dirs[..., 2], np)
    vv = np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h)[1]
    d_omega = (2 * np.pi / w) * (np.pi / h) * np.sin(vv * np.pi)
    sh = np.einsum("hwk,hwc,hw->kc", basis, env, d_omega)
    return sh.astype(np.float32)


_A = (math.pi, 2.094395, 2.094395, 2.094395, 0.785398, 0.785398, 0.785398,
      0.785398, 0.785398)
_A_ON = {}  # the band weights, copied to each device once


def _band_weights(device) -> torch.Tensor:
    if device not in _A_ON:
        _A_ON[device] = torch.tensor(np.asarray(_A, np.float32), device=device)
    return _A_ON[device]


def sh_irradiance(sh: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Diffuse irradiance E(n)/π for normals (..., 3) from SH-9 (9, 3)."""
    x, y, z = normals.unbind(-1)
    basis = _sh9_basis(x, y, z, torch)
    e = torch.einsum("...k,k,kc->...c", basis, _band_weights(normals.device),
                     sh)
    return torch.clamp(e / math.pi, min=0.0)


def _hammersley(samples: int) -> tuple[np.ndarray, np.ndarray]:
    i = np.arange(samples, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = (((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1))
    bits = (((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2))
    bits = (((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4))
    bits = (((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8))
    u2 = (bits & 0xFFFFFFFF).astype(np.float64) * 2.3283064365386963e-10
    u1 = (i + 0.5) / samples
    return u1, u2


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def prefilter_envmap_ggx(
    env: np.ndarray,
    levels: int = 5,
    out_hw: tuple[int, int] = (128, 256),
    samples: int = 128,
    device=devices.DEFAULT,
) -> np.ndarray:
    """Split-sum prefilter: the envmap convolved with the GGX NDF at
    roughness ``i / (levels - 1)`` for level ``i`` (N = V = R), all
    levels at ``out_hw``; (L, H, W, 3) float32 numpy.  The convolution
    runs on ``device``."""
    device = devices.resolve(device)
    env_t = torch.tensor(np.asarray(env, np.float32), device=device)
    h, w = out_hw
    n = torch.tensor(texel_directions(h, w).reshape(-1, 3), device=device)
    u1, u2 = _hammersley(samples)
    u1 = torch.tensor(u1, dtype=torch.float32, device=device)
    u2 = torch.tensor(u2, dtype=torch.float32, device=device)

    def level(alpha: float) -> torch.Tensor:
        t = _cross(helper_axis(n, 0.999), n)
        t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                            min=1e-9)
        b = _cross(n, t)
        phi = 2.0 * math.pi * u1
        a = torch.tensor(alpha, dtype=torch.float32, device=device)
        a2 = a * a
        ct = torch.sqrt((1.0 - u2) / (1.0 + (a2 - 1.0) * u2))
        st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
        hx = st * torch.cos(phi)
        hy = st * torch.sin(phi)
        hv = (hx[None, :, None] * t[:, None, :]
              + hy[None, :, None] * b[:, None, :]
              + ct[None, :, None] * n[:, None, :])  # (P, S, 3)
        vdh = torch.sum(n[:, None, :] * hv, dim=-1, keepdim=True)
        l = 2.0 * vdh * hv - n[:, None, :]
        ndl = torch.clamp(torch.sum(n[:, None, :] * l, dim=-1), min=0.0)
        rad = sample_envmap(env_t, l)
        wsum = torch.clamp(torch.sum(ndl, dim=1, keepdim=True), min=1e-6)
        return torch.sum(rad * ndl[..., None], dim=1) / wsum

    out = []
    for li in range(levels):
        r = li / max(levels - 1, 1)
        if li == 0:  # roughness 0: a mirror, the env resampled
            out.append(sample_envmap(env_t, n))
        else:
            out.append(level(max(r * r, 1e-4)))
    return torch.stack(out).reshape(levels, h, w, 3).cpu().numpy()


def sample_envmap_stack(
    stack: torch.Tensor, dirs: torch.Tensor, roughness
) -> torch.Tensor:
    """Trilinear lookup in a (L, H, W, 3) prefiltered stack; ``roughness``
    broadcasts against ``dirs[..., 0]``."""
    levels, h, w, _ = stack.shape
    flat = stack.reshape(levels * h, w, 3)
    rough = torch.as_tensor(roughness, dtype=dirs.dtype, device=dirs.device)
    rough = torch.broadcast_to(rough, dirs[..., 0].shape)
    f = torch.clamp(rough, 0.0, 1.0) * (levels - 1)
    l0 = torch.clamp(torch.floor(f).to(torch.int64), 0, levels - 1)
    l1 = torch.clamp(l0 + 1, max=levels - 1)
    lw = (f - l0.to(f.dtype))[..., None]

    uv = direction_to_uv(dirs)
    x = uv[..., 0] * w - 0.5
    y = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0c = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1c = torch.clamp(y0c + 1, 0, h - 1)

    def bilerp(lvl):
        yo = lvl * h
        c00 = flat[yo + y0c, x0i]
        c01 = flat[yo + y0c, x1i]
        c10 = flat[yo + y1c, x0i]
        c11 = flat[yo + y1c, x1i]
        return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
                + c10 * (1 - fx) * fy + c11 * fx * fy)

    return bilerp(l0) * (1.0 - lw) + bilerp(l1) * lw


def env_brdf_approx(ndv: torch.Tensor, roughness):
    """Karis' analytic fit of the split-sum environment BRDF: (A, B) with
    specular ≈ F0·A + B."""
    r = torch.as_tensor(roughness, dtype=ndv.dtype, device=ndv.device)
    x = -1.0 * r + 1.0
    y = -0.0275 * r + 0.0425
    z = -0.572 * r + 1.04
    w = 0.022 * r - 0.04
    a004 = torch.minimum(x * x, torch.exp2(-9.28 * ndv)) * x + y
    return (-1.04 * a004 + z, 1.04 * a004 + w)


def mirror_scene_reflection(
    points: torch.Tensor,
    refl_dirs: torch.Tensor,
    tri_a: torch.Tensor,
    tri_b: torch.Tensor,
    tri_c: torch.Tensor,
    tri_color: torch.Tensor,
    env_sh: torch.Tensor,
    eps: float = 1e-3,
):
    """One-bounce scene reflection for mirrors: reflection rays against
    the scene mesh; a hit face returns its albedo lit Lambertianly by
    the envmap SH at its normal.  (radiance (R, 3), hit (R,) bool)."""
    origins = points + refl_dirs * eps
    _, tri_idx, hit = ray_mesh_first_hit(origins, refl_dirs, tri_a, tri_b,
                                         tri_c)
    fn = _cross(tri_b - tri_a, tri_c - tri_a)
    fn = fn / torch.clamp(torch.linalg.norm(fn, dim=-1, keepdim=True),
                          min=1e-9)
    n_hit = fn[tri_idx]  # index -1 (a miss) reads the last face: masked
    n_hit = torch.where(
        torch.sum(n_hit * refl_dirs, -1, keepdim=True) > 0, -n_hit, n_hit
    )
    albedo = tri_color[tri_idx]
    rad = albedo * sh_irradiance(env_sh, n_hit)
    return torch.where(hit[:, None], rad, torch.zeros_like(rad)), hit


def shade(
    normals: torch.Tensor,
    view_dirs: torch.Tensor,
    env: torch.Tensor,
    env_sh: torch.Tensor,
    base_color: torch.Tensor,
    roughness=0.5,
    metallic=0.0,
    emission: Optional[torch.Tensor] = None,
    env_ggx: Optional[torch.Tensor] = None,
    scene_spec: Optional[torch.Tensor] = None,
    scene_spec_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-point shading: albedo·E(n) + split-sum specular.

    ``normals``/``view_dirs`` (..., 3) unit, the view directions pointing
    toward the surface.  With ``env_ggx`` the specular is the split-sum
    GGX integral; without it, one mirror sample with a crude roughness
    attenuation.  ``scene_spec`` replaces the reflected radiance where
    ``scene_spec_mask`` is set."""
    n = normals
    v = -view_dirs
    ndv = torch.clamp(torch.sum(n * v, dim=-1, keepdim=True), min=0.0)
    refl = 2.0 * ndv * n - v

    as_t = lambda x: torch.as_tensor(x, dtype=n.dtype, device=n.device)
    rough, metal = as_t(roughness), as_t(metallic)
    diffuse = base_color * sh_irradiance(env_sh, n)
    f0 = 0.04 * (1.0 - metal) + metal * base_color
    if env_ggx is not None:
        rough_b = torch.broadcast_to(rough, refl[..., :1].shape)[..., 0]
        spec_env = sample_envmap_stack(env_ggx, refl, rough_b)
        if scene_spec is not None:
            spec_env = torch.where(scene_spec_mask, scene_spec, spec_env)
        a, b = env_brdf_approx(ndv, rough)
        spec = spec_env * (f0 * a + b)
    else:
        spec_env = sample_envmap(env, refl)
        if scene_spec is not None:
            spec_env = torch.where(scene_spec_mask, scene_spec, spec_env)
        fresnel = f0 + (1.0 - f0) * (1.0 - ndv) ** 5
        spec = spec_env * fresnel * (1.0 - 0.85 * rough)
    out = diffuse * (1.0 - metal) + spec
    if emission is not None:
        out = out + emission
    return out
