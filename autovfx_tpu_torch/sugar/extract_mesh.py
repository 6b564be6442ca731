"""SuGaR surface-mesh extraction (the coarse mesh).

Counterpart of ``autovfx_tpu/sugar/extract_mesh.py`` (itself
``sugar_extractors/coarse_mesh.py:13-767``): per-camera level-set
clouds (:252-296), outlier removal (:393-397), the foreground surface
(:398-409: screened Poisson, TSDF fusion or the density grid), a coarse
density-grid background, quadric decimation and the density prune
(:441-458), nearest-Gaussian vertex colours, the mesh write (:496).

What the JAX package ran on the device runs on the Gaussians' device
here (the renders, the density field, the k-NN, the Poisson solve); the
meshing, decimation and pruning stay numpy on the host.  Each stage is a
function of this module or of ``poisson``, so a caller can time them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.cameras import Camera, index_camera, num_cameras
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.core.sh import sh_to_rgb
from autovfx_tpu_torch.edit import mesh_io
from autovfx_tpu_torch.ops.knn import knn_indices
from autovfx_tpu_torch.ops.rasterize import RasterConfig
from autovfx_tpu_torch.sugar import density as D
from autovfx_tpu_torch.sugar.decimate import (
    decimate_quadric,
    density_quantile_prune,
)
from autovfx_tpu_torch.sugar.levelset import (
    _nearest_gaussian,
    level_surface_from_camera,
)
from autovfx_tpu_torch.sugar.marching import marching_tetrahedra
from autovfx_tpu_torch.sugar.poisson import poisson_mesh_from_gaussians
from autovfx_tpu_torch.sugar.sdf_fusion import grid_points, tsdf_mesh

GRID_CHUNK = 1 << 18  # grid points per density evaluation


def extract_level_points(
    g: Gaussians,
    cams: Camera,
    config: RasterConfig = RasterConfig(),
    every_nth: int = 3,
    level: float = 0.3,
    pixel_stride: int = 2,
):
    """Union of the level-set samples of every ``every_nth`` camera, as
    host arrays (points, normals)."""
    pts, nrm = [], []
    for i in range(0, num_cameras(cams), every_nth):
        ls = level_surface_from_camera(g, index_camera(cams, i), config=config,
                                       level=level, pixel_stride=pixel_stride)
        m = ls.valid
        pts.append(ls.points[m].cpu().numpy())
        nrm.append(ls.normals[m].cpu().numpy())
    return np.concatenate(pts), np.concatenate(nrm)


@torch.no_grad()
def remove_outliers(points: np.ndarray, normals: np.ndarray, k: int = 16,
                    std_ratio: float = 2.0, device=devices.DEFAULT):
    """Statistical outlier removal: drop points whose mean k-NN distance
    exceeds the mean by ``std_ratio`` deviations (the k-NN on
    ``device``)."""
    dev = devices.resolve(device)
    _, d2 = knn_indices(torch.as_tensor(points, device=dev), k=k)
    mean_d = torch.sqrt(torch.clamp(d2, min=0.0)).mean(dim=1).cpu().numpy()
    mu, sd = mean_d.mean(), mean_d.std()
    keep = mean_d < mu + std_ratio * sd
    return points[keep], normals[keep]


@torch.no_grad()
def density_grid_mesh(
    g: Gaussians,
    bbox_min,
    bbox_max,
    resolution: int = 192,
    level: float = 0.3,
    k: int = 16,
    chunk: int = GRID_CHUNK,
):
    """Marching tetrahedra on the density field sampled over a grid
    (``coarse_mesh.py:725-764``'s marching-cubes alternative); a grid
    point's neighbour list is its nearest Gaussian's."""
    bbox_min = np.asarray(bbox_min, np.float32)
    bbox_max = np.asarray(bbox_max, np.float32)
    spacing = (bbox_max - bbox_min) / (resolution - 1)
    pts = grid_points(bbox_min, bbox_max, resolution)
    dev = g.xyz.device
    g_neighbors = D.reset_neighbors(g, k=k)
    dens = np.empty(len(pts), np.float32)
    for s in range(0, len(pts), chunk):
        # a short last chunk is padded with the origin, as in the JAX
        # package: the padding widens the Morton box of the joint sort
        pc = torch.zeros((chunk, 3), dtype=torch.float32, device=dev)
        n = len(pts[s:s + chunk])
        pc[:n] = torch.as_tensor(pts[s:s + chunk], device=dev)
        nbrs = g_neighbors[_nearest_gaussian(pc, g)]
        dens[s:s + n] = D.compute_density(pc[:n], nbrs[:n], g).cpu().numpy()
    grid = dens.reshape(resolution, resolution, resolution)
    return marching_tetrahedra(grid, level, bbox_min, spacing)


@torch.no_grad()
def prune_far_from_gaussians(verts, faces, g: Gaussians, quantile: float):
    """The density prune: support 1 / (1 + d²) to each vertex's nearest
    Gaussian, its lowest ``quantile`` dropped."""
    nearest = _nearest_gaussian(
        torch.as_tensor(verts, device=g.xyz.device), g).cpu().numpy()
    d2 = np.sum((verts - g.xyz.cpu().numpy()[nearest]) ** 2, axis=1)
    return density_quantile_prune(verts, faces, 1.0 / (1.0 + d2), quantile)


@torch.no_grad()
def vertex_colors(verts, g: Gaussians) -> np.ndarray:
    """Each vertex's nearest Gaussian's DC colour, in [0, 1]."""
    nearest = _nearest_gaussian(torch.as_tensor(verts, device=g.xyz.device), g)
    base = sh_to_rgb(0, g.sh[:, :1], torch.zeros_like(g.xyz))
    return np.clip(base[nearest].cpu().numpy(), 0, 1)


def extract_mesh_from_gaussians(
    g: Gaussians,
    cams: Camera,
    out_path: Optional[str] = None,
    config: RasterConfig = RasterConfig(),
    level: float = 0.3,
    fg_resolution: int = 192,
    bg_resolution: int = 96,
    target_vertices: int = 1_000_000,
    bbox_expand: float = 1.05,
    method: str = "poisson",
    density_prune_quantile: float = 0.1,
) -> mesh_io.Mesh:
    """The whole coarse-mesh extraction, on the Gaussians' device.

    The foreground box spans the camera centres (expanded) and is meshed
    at ``fg_resolution`` by ``method``: "poisson" (the screened-Poisson
    solve on the level-set cloud, ``sugar/poisson.py``), "tsdf" (fusion
    of level-set depth maps, ``sugar/sdf_fusion.py``) or
    "density_grid"; the background, 3x the box, is the density field's
    surface at ``bg_resolution`` without the faces inside the box.  Then
    quadric decimation to ``target_vertices``, the density prune and the
    vertex colours; written to ``out_path`` (.obj, else .ply)."""
    centers = cams.center.detach().cpu().numpy()
    c_min, c_max = centers.min(0), centers.max(0)
    c_ext = np.maximum(c_max - c_min, 0.5)
    mid = (c_min + c_max) / 2
    fg_min = mid - bbox_expand * c_ext
    fg_max = mid + bbox_expand * c_ext

    if method == "poisson":
        v_fg, f_fg = poisson_mesh_from_gaussians(
            g, cams, config=config, resolution=fg_resolution, level=level)
    elif method == "tsdf":
        v_fg, f_fg = tsdf_mesh(g, cams, fg_min, fg_max, config=config,
                               resolution=fg_resolution)
    else:
        v_fg, f_fg = density_grid_mesh(g, fg_min, fg_max,
                                       resolution=fg_resolution, level=level)
    # the background: the density field within 3x the foreground box
    # (the cameras rarely see it well enough for depth fusion)
    bg_min = mid - 3 * bbox_expand * c_ext
    bg_max = mid + 3 * bbox_expand * c_ext
    v_bg, f_bg = density_grid_mesh(g, bg_min, bg_max,
                                   resolution=bg_resolution, level=level)
    if len(f_bg):  # no second surface inside the foreground box
        fc = v_bg[f_bg].mean(1)
        inside = (fc > fg_min[None]).all(1) & (fc < fg_max[None]).all(1)
        f_bg = f_bg[~inside]

    verts = np.concatenate([v_fg, v_bg]) if len(v_bg) else v_fg
    faces = np.concatenate([f_fg, f_bg + len(v_fg)]) if len(f_bg) else f_fg
    verts, faces = decimate_quadric(verts, faces, target_vertices)
    if density_prune_quantile and len(verts):
        verts, faces = prune_far_from_gaussians(verts, faces, g,
                                                density_prune_quantile)
    colors = vertex_colors(verts, g) if len(verts) else None
    mesh = mesh_io.Mesh(vertices=verts.astype(np.float32),
                        faces=faces.astype(np.int64), vertex_colors=colors)
    if out_path:
        if out_path.endswith(".obj"):
            mesh_io.save_obj(out_path, mesh)
        else:
            mesh_io.save_ply_mesh(out_path, mesh)
    return mesh
