"""Truncated SDF fusion of rendered level-set depth maps (``method="tsdf"``).

Counterpart of ``autovfx_tpu/sugar/sdf_fusion.py``: each camera adds
clamp((D(u,v) − z)/τ, −1, 1) at every grid point it sees, weighted
three ways by its pixel's evidence (surface, true background, unknown),
the cameras' sums are averaged against a weak solid prior, and the zero
crossing is meshed by marching tetrahedra, keeping only vertices within
two voxels of a direct surface observation.  The depth maps come from
the level-set crossings (``render_depth_maps``: two renders a camera
through kernels 1-3).  The fusion loops over the cameras on the device
where the JAX package scans them.
"""
from __future__ import annotations

import numpy as np
import torch

from autovfx_tpu_torch.core.cameras import (
    Camera,
    index_camera,
    num_cameras,
    stack_cameras,
)
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.sugar.levelset import level_surface_from_camera
from autovfx_tpu_torch.sugar.marching import marching_tetrahedra
from autovfx_tpu_torch.utils.gather import take


def _window_max(a: np.ndarray, r: int = 2) -> np.ndarray:
    """Per-frame (C, H, W) max filter over a (2r+1)² window."""
    out = a.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out = np.maximum(out, np.roll(np.roll(a, dy, axis=1), dx, axis=2))
    return out


def grid_points(bbox_min, bbox_max, resolution: int) -> np.ndarray:
    """(R³, 3) float32 grid points, x slowest (float64 linspace)."""
    axes = [np.linspace(bbox_min[i], bbox_max[i], resolution)
            for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    return np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)


@torch.no_grad()
def tsdf_fuse(
    cams: Camera,
    depths,  # (C, H, W) view-z depth
    valids,  # (C, H, W) alpha coverage in [0, 1]
    bbox_min,
    bbox_max,
    resolution: int = 192,
    trunc: float | None = None,
    return_weights: bool = False,
):
    """(R, R, R) fused TSDF on the host: negative behind surfaces, +1 in
    free space, computed on the cameras' device.  ``trunc`` defaults to 3
    voxel diagonals; ``return_weights`` also returns each voxel's
    in-band weight (how many views saw a surface within one band)."""
    dev = cams.R.device
    bbox_min = np.asarray(bbox_min, np.float32)
    bbox_max = np.asarray(bbox_max, np.float32)
    spacing = (bbox_max - bbox_min) / (resolution - 1)
    if trunc is None:
        trunc = 3.0 * float(np.linalg.norm(spacing))
    pts = torch.as_tensor(grid_points(bbox_min, bbox_max, resolution),
                          device=dev)
    valids_np = np.asarray(valids, np.float32)
    h, w = valids_np.shape[1:]
    # a pixel is TRUE background only if its whole neighbourhood is
    # empty: an isolated low-alpha pixel is a splat-gap leak, not free
    # space, and must not carve through the object
    alpha_dil = torch.as_tensor(_window_max(valids_np, r=2), device=dev)
    depths = torch.as_tensor(np.asarray(depths, np.float32), device=dev)
    valids = torch.as_tensor(valids_np, device=dev)
    zeros = lambda: torch.zeros(pts.shape[0], dtype=torch.float32, device=dev)
    acc, wsum, band = zeros(), zeros(), zeros()
    for i in range(depths.shape[0]):
        cam = index_camera(cams, i)
        uv, z = cam.project(pts)
        ui = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, w - 1)
        vi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, h - 1)
        in_img = ((uv[:, 0] >= -0.5) & (uv[:, 0] <= w - 0.5)
                  & (uv[:, 1] >= -0.5) & (uv[:, 1] <= h - 0.5) & (z > 1e-3))
        pix = vi * w + ui
        # alpha ≈ 1: a surface at its depth (full weight); alpha ≈ 0: true
        # background, free to infinity (reduced weight); partial alpha:
        # a silhouette or a leak, no evidence
        is_surf = take(valids[i].reshape(-1), pix) > 0.5
        is_free = take(alpha_dil[i].reshape(-1), pix) < 0.1
        d = torch.where(is_surf, take(depths[i].reshape(-1), pix),
                        torch.full_like(z, 1e9))
        sd = (d - z) / trunc
        tsdf = torch.clamp(sd, -1.0, 1.0)
        # full weight only inside the band around a surface observation;
        # carving far in front of one, or through true background, weighs
        # less, and space more than a band behind a surface is occluded
        in_band = is_surf & (sd > -1.0) & (sd <= 1.0)
        carving = is_free | (is_surf & (sd > 1.0))
        one, zero = torch.ones_like(z), torch.zeros_like(z)
        wgt = torch.where(in_img, torch.where(
            in_band, one, torch.where(carving, torch.full_like(z, 0.25),
                                      zero)), zero)
        acc = acc + wgt * tsdf
        wsum = wsum + wgt
        band = band + torch.where(in_band, one, zero)
    # a weak solid prior: space no view observes, or views contradict,
    # counts as interior
    prior_w = 0.3
    phi = ((acc - prior_w) / (wsum + prior_w)).cpu().numpy()
    shape = (resolution,) * 3
    phi = phi.reshape(shape)
    if return_weights:
        return phi, band.cpu().numpy().reshape(shape)
    return phi


def render_depth_maps(
    g: Gaussians,
    cams: Camera,
    config: RasterConfig = RasterConfig(),
    every_nth: int = 3,
    pixel_stride: int = 2,
    level: float = 0.3,
):
    """(sub-sampled cameras, depth maps, coverage maps) of every
    ``every_nth`` camera: the depth is the level-set crossing along each
    pixel ray (the median surface, not the alpha-weighted mean that
    blends front and back surfaces), 1e9 where there is none; a covered
    pixel without a clean crossing gets alpha at most 0.49 (unknown)."""
    depths, valids, sub_list = [], [], []
    for i in range(0, num_cameras(cams), every_nth):
        cam = index_camera(cams, i)
        cam_s = cam.resized(pixel_stride)
        hs, ws = cam_s.height, cam_s.width
        h2 = len(range(0, cam.height, pixel_stride))
        w2 = len(range(0, cam.width, pixel_stride))
        with torch.no_grad():
            out = rasterize(g, cam, config=config)
        a = out.alpha.cpu().numpy()[::pixel_stride, ::pixel_stride][:hs, :ws]
        ls = level_surface_from_camera(g, cam, config=config, level=level,
                                       pixel_stride=pixel_stride)
        _, z = cam.project(ls.points)
        zmap = z.cpu().numpy().reshape(h2, w2)[:hs, :ws]
        ok = ls.valid.cpu().numpy().reshape(h2, w2)[:hs, :ws]
        depths.append(np.where(ok, zmap, 1e9).astype(np.float32))
        valids.append(np.where(ok, a, np.minimum(a, 0.49)).astype(np.float32))
        sub_list.append(cam_s)
    return stack_cameras(sub_list), np.stack(depths), np.stack(valids)


def tsdf_mesh(
    g: Gaussians,
    cams: Camera,
    bbox_min,
    bbox_max,
    config: RasterConfig = RasterConfig(),
    resolution: int = 192,
    every_nth: int = 3,
):
    """Depth maps -> TSDF fusion -> marching tetrahedra at φ = 0."""
    sub, depths, valids = render_depth_maps(g, cams, config=config,
                                            every_nth=every_nth)
    phi, band = tsdf_fuse(sub, depths, valids, bbox_min, bbox_max,
                          resolution=resolution, return_weights=True)
    # the surface evidence, dilated 2 voxels (a marching vertex may sit
    # in a cell beside the observed band)
    band_d = band
    for ax in (0, 1, 2):
        for sh in (-2, -1, 1, 2):
            band_d = np.maximum(band_d, np.roll(band, sh, axis=ax))
    bbox_min = np.asarray(bbox_min, np.float32)
    spacing = (np.asarray(bbox_max, np.float32) - bbox_min) / (resolution - 1)
    # marching_tetrahedra meshes {field >= level}: inside is -φ >= 0
    verts, faces = marching_tetrahedra(-phi, 0.0, bbox_min, spacing)
    if len(verts):
        # no surface evidence, no surface: the carve-against-prior
        # boundary at the edge of covered space is not geometry
        cell = np.clip(((verts - bbox_min[None]) / spacing[None])
                       .astype(np.int64), 0, resolution - 1)
        keep_v = band_d[cell[:, 0], cell[:, 1], cell[:, 2]] > 0.5
        faces = faces[keep_v[faces].all(axis=1)]
        used = np.zeros(len(verts), bool)
        used[faces.reshape(-1)] = True
        new_id = np.cumsum(used) - 1
        verts = verts[used]
        faces = new_id[faces]
    return verts, faces
