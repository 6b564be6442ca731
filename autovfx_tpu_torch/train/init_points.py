"""Init points for 3DGS training: SfM points, points cast onto a scene
mesh from training-view pixels, or both.

Counterpart of ``autovfx_tpu/train/init_points.py`` (the reference's
``init_strategy`` in {colmap, ray_mesh, hybrid},
``scene/dataset_readers.py:176-289``).  The rays are cast on ``device``
by ``ops.raymesh``; the pixel draws are numpy's, seeded, as the
reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.cameras import Camera, index_camera, num_cameras
from autovfx_tpu_torch.ops.raymesh import ray_mesh_first_hit


def ray_mesh_init_points(
    cams: Camera,
    images: np.ndarray,  # (V, H, W, 3) float in [0, 1]
    vertices: np.ndarray,
    faces: np.ndarray,
    num_points: int,
    seed: int = 0,
    rays_per_batch: int = 65_536,
    device=devices.DEFAULT,
) -> tuple[np.ndarray, np.ndarray]:
    """(xyz (N, 3), rgb (N, 3)) float32 numpy from rays through random
    training-view pixels that hit the mesh; misses are dropped, at most 8
    batches of rays are cast.  ``cams`` is a stacked Camera."""
    device = devices.resolve(device)
    v = torch.tensor(np.asarray(vertices, np.float32), device=device)
    f = torch.tensor(np.asarray(faces, np.int64), device=device)
    ta, tb, tc = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cams = Camera(**{k: (getattr(cams, k).to(device) if k not in
                         ("width", "height") else getattr(cams, k))
                     for k in ("R", "t", "fx", "fy", "cx", "cy", "width",
                               "height")})
    n_views = num_cameras(cams)
    h, w = images.shape[1:3]
    rng = np.random.RandomState(seed)

    def cast(view_idx, px, py):
        cam = index_camera(cams, view_idx)
        x = (px.to(torch.float32) + 0.5 - cam.cx) / cam.fx
        y = (py.to(torch.float32) + 0.5 - cam.cy) / cam.fy
        R = cam.R  # camera -> world: rows times R, i.e. R^T applied
        d_world = torch.stack(
            [x * R[0, k] + y * R[1, k] + R[2, k] for k in range(3)], dim=-1)
        d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
        origins = cam.center.expand_as(d_world)
        t, _, hit = ray_mesh_first_hit(origins, d_world, ta, tb, tc)
        return origins + t[:, None] * d_world, hit

    pts_out, rgb_out = [], []
    got = 0
    for _ in range(8):
        if got >= num_points:
            break
        vi = rng.randint(0, n_views)
        px = rng.randint(0, w, size=rays_per_batch)
        py = rng.randint(0, h, size=rays_per_batch)
        pts, hit = cast(vi, torch.tensor(px, device=device),
                        torch.tensor(py, device=device))
        hit = hit.cpu().numpy()
        pts = pts.cpu().numpy()[hit]
        cols = np.asarray(images[vi])[py[hit], px[hit]]
        pts_out.append(pts)
        rgb_out.append(cols)
        got += len(pts)

    if not got:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    xyz = np.concatenate(pts_out)[:num_points]
    rgb = np.concatenate(rgb_out)[:num_points]
    return xyz.astype(np.float32), rgb.astype(np.float32)


def build_init_points(
    strategy: str,
    colmap_xyz: np.ndarray,
    colmap_rgb: np.ndarray,
    cams: Camera | None = None,
    images: np.ndarray | None = None,
    mesh_vertices: np.ndarray | None = None,
    mesh_faces: np.ndarray | None = None,
    seed: int = 0,
    device=devices.DEFAULT,
) -> tuple[np.ndarray, np.ndarray]:
    """Points and colors for ``strategy``: "colmap" (the SfM points),
    "ray_mesh" (as many mesh points as SfM points) or "hybrid" (both)."""
    if strategy == "colmap":
        devices.resolve(device)
        return (np.asarray(colmap_xyz, np.float32),
                np.asarray(colmap_rgb, np.float32))
    if strategy not in ("ray_mesh", "hybrid"):
        raise ValueError(f"unknown init_strategy {strategy!r}")
    if mesh_vertices is None or mesh_faces is None:
        raise ValueError(f"init_strategy={strategy} requires a scene mesh")
    n = len(colmap_xyz)
    rm_xyz, rm_rgb = ray_mesh_init_points(
        cams, np.asarray(images), mesh_vertices, mesh_faces, n, seed=seed,
        device=device)
    if strategy == "ray_mesh":
        return rm_xyz, rm_rgb
    return (np.concatenate([np.asarray(colmap_xyz, np.float32), rm_xyz]),
            np.concatenate([np.asarray(colmap_rgb, np.float32), rm_rgb]))
