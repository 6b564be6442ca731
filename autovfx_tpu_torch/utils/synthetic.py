"""Procedural test scenes made from a seeded numpy generator.

Counterpart of ``autovfx_tpu/utils/synthetic.py``: the same shapes and
distributions (SH degree 3, a flat ground disc, mid-height clutter and a
far shell), but numpy's random numbers, so a scene made here is not the
one the JAX package makes from the same seed.  To compare the two
packages on one scene, build it there and carry it over with
``autovfx_tpu_torch.convert``.
"""
from __future__ import annotations

import numpy as np
import torch

from autovfx_tpu_torch.core.cameras import Camera, look_at_camera
from autovfx_tpu_torch.core.gaussians import Gaussians, merge


def make_gaussians(
    n: int,
    rng: np.random.Generator,
    spread: float = 1.0,
    scale_range: tuple[float, float] = (0.01, 0.08),
    sh_degree: int = 3,
    opacity_range: tuple[float, float] = (0.2, 0.95),
    device="cpu",
) -> Gaussians:
    f32 = np.float32
    xyz = rng.standard_normal((n, 3), dtype=f32) * f32(spread)
    rgb = rng.random((n, 3), dtype=f32)
    k = (sh_degree + 1) ** 2
    sh_rest = f32(0.05) * rng.standard_normal((n, k - 1, 3), dtype=f32)
    lo, hi = scale_range
    log_s = np.log(rng.uniform(lo, hi, (n, 3)).astype(f32))
    quats = rng.standard_normal((n, 4), dtype=f32)
    quats /= np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    op = rng.uniform(*opacity_range, n).astype(f32)
    c0 = f32(0.28209479177387814)
    t = lambda a: torch.from_numpy(a).to(device)
    return Gaussians(
        xyz=t(xyz),
        sh_dc=t((rgb - f32(0.5)) / c0),
        sh_rest=t(sh_rest),
        log_scales=t(log_s),
        quats=t(quats),
        opacity_logit=t(np.log(op / (1 - op))),
        active=torch.ones(n, dtype=torch.bool, device=device),
    )


def make_garden_like(
    n: int = 3_000_000, seed: int = 0, extent: float = 3.0, device="cpu"
) -> Gaussians:
    """A Garden-scale splat cloud: dense ground disc + clutter + far shell."""
    rng = np.random.default_rng(seed)
    n_ground = n // 2
    n_mid = n // 3
    n_far = n - n_ground - n_mid
    g_ground = make_gaussians(n_ground, rng, spread=extent,
                              scale_range=(0.004, 0.02), device=device)
    g_ground.xyz[:, 2] *= 0.02  # in place: the tensor is this function's own
    g_mid = make_gaussians(n_mid, rng, spread=extent * 0.5,
                           scale_range=(0.004, 0.03), device=device)
    g_mid.xyz[:, 2] += 0.5
    g_far = make_gaussians(n_far, rng, spread=extent * 3.0,
                           scale_range=(0.05, 0.2), device=device)
    return merge(merge(g_ground, g_mid), g_far)


def garden_camera(width: int = 1296, height: int = 840, device="cpu") -> Camera:
    """The Garden demo intrinsics at ``width`` x ``height``."""
    scale = width / 1296.0
    return look_at_camera(
        eye=[2.2, 1.2, 1.6],
        target=[0.0, 0.0, 0.2],
        up=[0.0, 0.0, 1.0],
        fx=960.98 * scale,
        fy=963.15 * scale,
        width=width,
        height=height,
        device=device,
    )
