"""Mesh -> surfel Gaussians for inserted objects.

Counterpart of ``autovfx_tpu/render/meshsplat.py``: an object mesh is
sampled into flat, normal-aligned surfel Gaussians, shaded by the
envmap IBL and rasterized with the scene's own kernels, so one renderer
resolves the depth order of object and scene.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.core.quaternion import helper_axis, rotmat_to_quat
from autovfx_tpu_torch.core.sh import rgb_to_sh

SURFEL_FIELDS = ("points", "normals", "colors", "radius", "tri", "bary")


def _sample_numpy(
    vertices: np.ndarray,
    faces: np.ndarray,
    num_samples: int = 100_000,
    vertex_colors: Optional[np.ndarray] = None,
    uv: Optional[np.ndarray] = None,
    texture: Optional[np.ndarray] = None,
    seed: int = 0,
) -> dict:
    """``sample_mesh_surfels``'s samples as numpy arrays."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cross = np.cross(b - a, c - a)
    area2 = np.linalg.norm(cross, axis=1)
    area = 0.5 * area2
    total_area = float(area.sum())
    p = area / max(area.sum(), 1e-12)
    rng = np.random.RandomState(seed)
    tri = rng.choice(len(f), size=num_samples, p=p)
    r1 = np.sqrt(rng.uniform(size=(num_samples, 1)))
    r2 = rng.uniform(size=(num_samples, 1))
    w0 = 1 - r1
    w1 = r1 * (1 - r2)
    w2 = r1 * r2
    pts = w0 * a[tri] + w1 * b[tri] + w2 * c[tri]
    normals = cross[tri] / np.maximum(area2[tri][:, None], 1e-12)

    if vertex_colors is not None:
        vc = np.asarray(vertex_colors, np.float64)
        cols = w0 * vc[f[tri, 0]] + w1 * vc[f[tri, 1]] + w2 * vc[f[tri, 2]]
    elif uv is not None and texture is not None:
        uvs = w0 * uv[f[tri, 0]] + w1 * uv[f[tri, 1]] + w2 * uv[f[tri, 2]]
        th, tw, _ = texture.shape
        xi = np.clip((uvs[:, 0] % 1.0) * tw, 0, tw - 1).astype(int)
        yi = np.clip(((1 - uvs[:, 1]) % 1.0) * th, 0, th - 1).astype(int)
        cols = np.asarray(texture, np.float64)[yi, xi] / (
            255.0 if texture.dtype == np.uint8 else 1.0
        )
    else:
        cols = np.full((num_samples, 3), 0.7)

    radius = np.sqrt(total_area / max(num_samples, 1)) * 1.1
    return {
        "points": pts.astype(np.float32),
        "normals": normals.astype(np.float32),
        "colors": cols.astype(np.float32),
        "radius": np.float32(radius),
        "tri": tri.astype(np.int64),
        "bary": np.concatenate([w0, w1, w2], axis=1).astype(np.float32),
    }


def sample_mesh_surfels(
    vertices: np.ndarray,
    faces: np.ndarray,
    num_samples: int = 100_000,
    vertex_colors: Optional[np.ndarray] = None,
    uv: Optional[np.ndarray] = None,
    texture: Optional[np.ndarray] = None,
    seed: int = 0,
    device=devices.DEFAULT,
) -> dict:
    """Area-weighted surface samples of a mesh as tensors on ``device``:
    ``points``, ``normals``, ``colors`` (N, 3) float32, ``radius`` (0-d,
    sized so the surfels tile the surface), and the (triangle,
    barycentric) association ``tri`` (N,) int64, ``bary`` (N, 3).  The
    draws are numpy's, the reference's for the same seed."""
    device = devices.resolve(device)
    s = _sample_numpy(vertices, faces, num_samples, vertex_colors, uv,
                      texture, seed)
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in s.items()}


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def surfels_to_gaussians(
    points: torch.Tensor,
    normals: torch.Tensor,
    colors: torch.Tensor,
    radius: float,
    opacity: float = 0.95,
    flat_ratio: float = 0.1,
) -> Gaussians:
    """Normal-aligned flat Gaussians (the smallest axis is the normal),
    SH degree 3 with only the DC band set."""
    n = points.shape[0]
    nrm = normals / torch.clamp(
        torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-12)
    t1 = _cross(helper_axis(nrm, 0.9), nrm)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True),
                          min=1e-12)
    t2 = _cross(nrm, t1)
    rot = torch.stack([t1, t2, nrm], dim=-1)  # (N, 3, 3) columns
    quats = rotmat_to_quat(rot)
    radius = float(radius)
    scales = points.new_full((n, 3), radius)
    scales[:, 2] = radius * flat_ratio
    log_scales = torch.log(scales)
    op_logit = float(np.log(opacity / (1 - opacity)))
    return Gaussians(
        xyz=points,
        sh_dc=rgb_to_sh(colors),
        sh_rest=points.new_zeros((n, 15, 3)),
        log_scales=log_scales,
        quats=quats,
        opacity_logit=points.new_full((n,), op_logit),
        active=torch.ones((n,), dtype=torch.bool, device=points.device),
    )


def _rotate_rows(pts: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Row vectors rotated by ``rot``: ``pts @ rot.T``, spelled out."""
    x, y, z = pts.unbind(-1)
    return torch.stack(
        [x * rot[i, 0] + y * rot[i, 1] + z * rot[i, 2] for i in range(3)],
        dim=-1)


def shaded_object_gaussians(
    surfels: dict,
    env: torch.Tensor,
    env_sh: torch.Tensor,
    cam_center: torch.Tensor,
    base_color: Optional[torch.Tensor] = None,
    roughness: float = 0.5,
    metallic: float = 0.0,
    transform: Optional[tuple] = None,
    env_ggx: Optional[torch.Tensor] = None,
    mirror_scene: Optional[tuple] = None,
    emitter=None,
) -> Gaussians:
    """Transform, IBL-shade and splat one object's surfels (a dict of
    tensors, ``sample_mesh_surfels``).

    ``transform``: (scale, R (3, 3), t (3,)), world = R·(scale·p) + t.
    ``mirror_scene``: (tri_a, tri_b, tri_c, tri_color) of the scene mesh;
    reflection rays then return scene content.  ``emitter``: an
    ``emitter.EmitterLights`` whose direct light is added."""
    from autovfx_tpu_torch.render import ibl

    pts = surfels["points"]
    nrm = surfels["normals"]
    cols = surfels["colors"]
    radius = float(surfels["radius"])
    if transform is not None:
        s, r, t = transform
        pts = _rotate_rows(pts * s, r) + t
        nrm = _rotate_rows(nrm, r)
        radius = radius * float(s)

    view = pts - cam_center[None, :]
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True),
                              min=1e-12)
    facing = torch.sum(nrm * view, dim=-1, keepdim=True)
    nrm_s = torch.where(facing > 0, -nrm, nrm)
    albedo = cols if base_color is None else cols * base_color
    if "roughness" in surfels:
        roughness = surfels["roughness"][:, None]
    scene_spec = scene_mask = None
    if mirror_scene is not None:
        ta, tb, tc, tcol = mirror_scene
        ndv = torch.clamp(torch.sum(nrm_s * (-view), dim=-1, keepdim=True),
                          min=0.0)
        refl = 2.0 * ndv * nrm_s + view
        scene_spec, hit = ibl.mirror_scene_reflection(
            pts, refl, ta, tb, tc, tcol, env_sh)
        scene_mask = hit[:, None]
    shaded = ibl.shade(
        nrm_s, view, env, env_sh, albedo, roughness=roughness,
        metallic=metallic, env_ggx=env_ggx,
        scene_spec=scene_spec, scene_spec_mask=scene_mask,
    )
    if emitter is not None:
        from autovfx_tpu_torch.render.emitter import emitter_irradiance

        shaded = shaded + albedo * emitter_irradiance(pts, nrm_s, emitter)
    return surfels_to_gaussians(pts, nrm_s, shaded, radius)
