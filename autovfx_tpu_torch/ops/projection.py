"""Per-Gaussian screen-space preprocess: the plain PyTorch version.

Counterpart of ``autovfx_tpu/ops/projection.py`` (itself a restatement
of ``cuda_rasterizer/forward.cu`` preprocessCUDA / computeCov2D /
computeCov3D).  ``ops/preprocess_cuda.py`` runs the same arithmetic as
one CUDA thread per splat; this version is what a CPU tensor goes
through and what the kernel is held against.

Pixel convention as CUDA: centers at integer coordinates,
``mean2d = f * t_xy / t_z + c - 0.5``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from autovfx_tpu_torch.core.cameras import Camera
from autovfx_tpu_torch.core.gaussians import Gaussians

TILE = 16
NEAR_Z = 0.2  # in_frustum near cull
COV2D_DILATION = 0.3  # low-pass filter added to the 2D covariance


class Splats2D(NamedTuple):
    """Screen-space Gaussians, one slot per input Gaussian."""

    mean2d: torch.Tensor  # (N, 2) f32 pixel coords
    conic: torch.Tensor  # (N, 3) f32 inverse 2D covariance (a, b, c)
    color: torch.Tensor  # (N, 3) f32 RGB
    opacity: torch.Tensor  # (N,) f32, 0 where culled
    depth: torch.Tensor  # (N,) f32 view-space z
    radius: torch.Tensor  # (N,) int32 pixel radius, 0 = culled
    tile_min: torch.Tensor  # (N, 2) int32 inclusive tile rect min (x, y)
    tile_max: torch.Tensor  # (N, 2) int32 exclusive tile rect max (x, y)
    tiles_touched: torch.Tensor  # (N,) int32 covered tiles


def num_tiles(width: int, height: int, tile: int = TILE) -> tuple[int, int]:
    return (width + tile - 1) // tile, (height + tile - 1) // tile


def compute_cov3d(g: Gaussians, scaling_modifier: float = 1.0) -> torch.Tensor:
    """(N, 6) packed upper-triangular world covariance
    [xx, xy, xz, yy, yz, zz] = Σ_k s_k² R_ik R_jk."""
    w, x, y, z = g.rotations.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s = g.scales * scaling_modifier
    s0, s1, s2 = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2
    c_xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    c_xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    c_xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    c_yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    c_yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    c_zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], dim=-1)


def preprocess(
    g: Gaussians,
    cam: Camera,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    tile: int = TILE,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Splats2D:
    """Project all Gaussians to screen space.

    ``mean2d_offset`` (N, 2) is added to ``mean2d`` before the tile rect;
    passed as zeros, its gradient is the screen-space position gradient
    that densification reads (the reference's ``screenspace_points``).
    """
    tiles_x, tiles_y = num_tiles(cam.width, cam.height, tile)
    R, t = cam.R, cam.t
    px_, py_, pz_ = g.xyz.unbind(-1)
    p_view = [px_ * R[i, 0] + py_ * R[i, 1] + pz_ * R[i, 2] + t[i]
              for i in range(3)]
    depth = p_view[2]
    in_front = depth > NEAR_Z
    safe_z = torch.where(in_front, depth, torch.ones_like(depth))
    mean2d = torch.stack(
        [
            cam.fx * p_view[0] / safe_z + cam.cx - 0.5,
            cam.fy * p_view[1] / safe_z + cam.cy - 0.5,
        ],
        dim=-1,
    )
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    # EWA 2D covariance (computeCov2D)
    limx = 1.3 * cam.tan_half_fovx
    limy = 1.3 * cam.tan_half_fovy
    tx = torch.clamp(p_view[0] / safe_z, -limx, limx) * safe_z
    ty = torch.clamp(p_view[1] / safe_z, -limy, limy) * safe_z
    tz = safe_z
    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = compute_cov3d(g, scaling_modifier).unbind(-1)

    # J rows: [fx/tz, 0, -fx*tx/tz^2], [0, fy/tz, -fy*ty/tz^2]; M = J @ R
    j00 = cam.fx / tz
    j02 = -(cam.fx * tx) / (tz * tz)
    j11 = cam.fy / tz
    j12 = -(cam.fy * ty) / (tz * tz)
    m0 = [j00 * R[0, i] + j02 * R[2, i] for i in range(3)]
    m1 = [j11 * R[1, i] + j12 * R[2, i] for i in range(3)]

    def sigma_dot(v):  # Σ @ v, packed symmetric
        return (
            c_xx * v[0] + c_xy * v[1] + c_xz * v[2],
            c_xy * v[0] + c_yy * v[1] + c_yz * v[2],
            c_xz * v[0] + c_yz * v[1] + c_zz * v[2],
        )

    s_m0 = sigma_dot(m0)
    s_m1 = sigma_dot(m1)
    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    cov_a = dot(m0, s_m0) + COV2D_DILATION
    cov_b = dot(m0, s_m1)
    cov_c = dot(m1, s_m1) + COV2D_DILATION

    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det != 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cov_c / safe_det, -cov_b / safe_det, cov_a / safe_det],
                        dim=-1)

    # Screen-space extent: 3σ, clamped to the exact α >= 1/255 support
    # r = σ·sqrt(2·ln(255·op)); the blend skips pixels beyond it anyway.
    mid = 0.5 * (cov_a + cov_c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    op = g.opacity
    nsigma = torch.sqrt(2.0 * torch.log(torch.clamp(op * 255.0, min=1.0 + 1e-6)))
    radius_f = torch.ceil(torch.clamp(nsigma, max=3.0) * torch.sqrt(lambda1))
    valid = in_front & det_ok

    # Tile rect (getRect): per-axis bound of the α-support ellipse, +1px
    # for the f32 band where the blend's alpha test and this analytic
    # bound disagree.  Truncating float -> int32 as the reference does
    # (clamping first gives the same ints and keeps the cast in range).
    rx = torch.ceil(torch.minimum(nsigma * torch.sqrt(cov_a) + 1.0, radius_f))
    ry = torch.ceil(torch.minimum(nsigma * torch.sqrt(cov_c) + 1.0, radius_f))
    mx, my = mean2d[:, 0], mean2d[:, 1]

    def rect(v, hi):
        return torch.clamp(v, 0.0, float(hi)).to(torch.int32)

    rmin_x = rect((mx - rx) / tile, tiles_x)
    rmin_y = rect((my - ry) / tile, tiles_y)
    rmax_x = rect((mx + rx + tile - 1) / tile, tiles_x)
    rmax_y = rect((my + ry + tile - 1) / tile, tiles_y)
    area = (rmax_x - rmin_x) * (rmax_y - rmin_y)
    valid = valid & (area > 0) & g.active
    zero_i = torch.zeros_like(area)
    area = torch.where(valid, area, zero_i)
    radius = torch.where(valid, radius_f.to(torch.int32), zero_i)

    if override_color is not None:
        color = override_color.to(torch.float32)
    else:
        color = g.colors(cam.center, degree=sh_degree)

    return Splats2D(
        mean2d=mean2d,
        conic=conic,
        color=color,
        opacity=torch.where(valid, op, torch.zeros_like(op)),
        depth=depth,
        radius=radius,
        tile_min=torch.stack([rmin_x, rmin_y], dim=-1),
        tile_max=torch.stack([rmax_x, rmax_y], dim=-1),
        tiles_touched=area,
    )
