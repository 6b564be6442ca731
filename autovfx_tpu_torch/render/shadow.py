"""Shadow-catcher pass: envmap visibility ratio on the scene surface.

Counterpart of ``autovfx_tpu/render/shadow.py``.  The only blockers an
edit adds are the inserted objects, so the ratio at a background pixel
p is Σ_k w_k·vis_k(p) / Σ_k w_k over importance-sampled envmap
directions k, with vis_k a ray-vs-convex-hull slab test against every
object's hull planes (n·x <= d).  Surface points come from
backprojecting the splat depth map.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from autovfx_tpu_torch.core.cameras import Camera
from autovfx_tpu_torch.core.quaternion import quat_to_rotmat

BIG = 1e30
PARALLEL = 1e-9  # |n·d| at or below this: the ray runs along the plane
# lights are tested together in chunks of at most this many (pixel,
# hull, plane, light) elements a temporary: fewer launches, bounded memory
CHUNK_ELEMENTS = 1 << 26


def _interval(denom: torch.Tensor, t_plane: torch.Tensor,
              outside: torch.Tensor, mask: torch.Tensor):
    """(t_exit, t_enter) of a ray through convex planes, reduced over the
    last axis: a plane with n·d > 1e-9 bounds t from above at
    ``t_plane``, one with n·d < -1e-9 from below; a masked-in plane the
    ray runs along (|n·d| <= 1e-9) that its origin lies ``outside`` of
    means it never enters (t_exit = -1e30).  ``denom``, ``outside`` and
    ``mask`` broadcast against ``t_plane``; the decisions are the
    reference's plane for plane."""
    exits = (denom > PARALLEL) & mask
    enters = (denom < -PARALLEL) & mask
    t_exit = torch.where(exits, t_plane, BIG).amin(dim=-1)
    t_enter = torch.where(enters, t_plane, -BIG).amax(dim=-1)
    never = (mask & ~(exits | enters) & outside).any(dim=-1)
    return torch.where(never, -BIG, t_exit), t_enter


def _hit(t_exit: torch.Tensor, t_enter: torch.Tensor) -> torch.Tensor:
    return (t_exit > torch.clamp(t_enter, min=1e-4)) & (t_exit > 0)


def ray_hits_hull(
    origins: torch.Tensor,  # (..., 3)
    direction: torch.Tensor,  # (3,) or (..., 3)
    planes: torch.Tensor,  # (F, 4) world-frame planes n·x <= d
    plane_mask: torch.Tensor,  # (F,)
) -> torch.Tensor:
    """Does the ray origin + t·direction, t > 0, enter the hull?  The
    intervals' intersection [t_enter, t_exit] must be non-empty with
    t_exit > max(t_enter, 1e-4)."""
    n = planes[:, :3]
    d = planes[:, 3]
    denom = torch.einsum("...i,fi->...f", direction, n)
    dist = d - torch.einsum("...i,fi->...f", origins, n)
    # the t of a plane is read only where |n·d| > 1e-9
    return _hit(*_interval(denom, dist / denom, dist < 0, plane_mask))


def trim_hull_planes(planes, plane_mask, align: int = 8):
    """Drop the all-padded trailing plane slots (hulls are padded to 64
    faces; a box uses 6), keeping a multiple of ``align``; works on
    numpy arrays or tensors."""
    mask = np.asarray(plane_mask.cpu() if torch.is_tensor(plane_mask)
                      else plane_mask)
    real = int(mask.sum(axis=1).max()) if mask.size else 0
    keep = min(max(-(-real // align) * align, align), mask.shape[1])
    return planes[:, :keep], plane_mask[:, :keep]


def world_hull_planes(planes_body, plane_mask, rot, pos):
    """Body-frame hull planes -> world frame for one body."""
    n_w = planes_body[:, :3] @ rot.T
    d_w = planes_body[:, 3] + n_w @ pos
    return torch.cat([n_w, d_w[:, None]], dim=-1), plane_mask


def _box_down(x: torch.Tensor, scale: int, hs: int, ws: int) -> torch.Tensor:
    """Mean of ``scale`` × ``scale`` blocks of the image padded to (or cut
    to) (hs·scale, ws·scale); padding repeats its last row and column."""
    h2, w2 = hs * scale, ws * scale
    pad = (0, max(w2 - x.shape[1], 0), 0, max(h2 - x.shape[0], 0))
    if any(pad):
        x = F.pad(x[None, None], pad, mode="replicate")[0, 0]
    x = x[:h2, :w2]
    return x.reshape(hs, scale, ws, scale).mean(dim=(1, 3))


def shadow_ratio_map(
    cam: Camera,
    depth: torch.Tensor,  # (H, W) alpha-weighted splat depth (view z)
    alpha: torch.Tensor,  # (H, W) background coverage
    light_dirs: torch.Tensor,  # (K, 3)
    light_weights: torch.Tensor,  # (K,)
    hull_planes: torch.Tensor,  # (B, F, 4) world-frame planes
    hull_mask: torch.Tensor,  # (B, F)
    bias: float = 1e-2,
    scale: int = 1,
) -> torch.Tensor:
    """(H, W) shadow ratio in [0, 1], 1 = fully lit.

    ``scale`` > 1 evaluates it on a grid ``scale`` times coarser (a box
    mean of the depth and alpha) and upsamples bilinearly.  The
    light-independent slack d - n·p of each (pixel, plane) is computed
    once; each light then costs a multiply by the plane's reciprocal
    denominator and the min/max reductions."""
    full_hw = depth.shape
    if scale > 1:
        cam = cam.resized(scale)
        depth = _box_down(depth, scale, cam.height, cam.width)
        alpha = _box_down(alpha, scale, cam.height, cam.width)

    z = depth / torch.clamp(alpha, min=1e-6)
    rays = cam.ray_directions()  # (H, W, 3), per unit view z
    pts = cam.center[None, None, :] + rays * z[..., None]
    pts = pts - bias * rays  # toward the camera, against self-occlusion

    nrm = hull_planes[..., :3]
    dvec = hull_planes[..., 3]
    denom_l = torch.einsum("ki,bfi->kbf", light_dirs, nrm)
    dist = dvec[None, None] - torch.einsum("hwi,bfi->hwbf", pts, nrm)
    # one reciprocal per (light, hull, plane), then a multiply per pixel
    inv_denom_l = 1.0 / torch.where(torch.abs(denom_l) > PARALLEL, denom_l,
                                    PARALLEL)
    outside = dist < 0

    lit = torch.zeros(pts.shape[:2], dtype=torch.float32, device=pts.device)
    chunk = max(1, CHUNK_ELEMENTS // max(dist.numel(), 1))
    for k in range(0, light_dirs.shape[0], chunk):
        ks = slice(k, k + chunk)
        per_light = lambda x: x[ks, None, None]  # (C, 1, 1, B, F)
        hit = _hit(*_interval(per_light(denom_l),
                              dist[None] * per_light(inv_denom_l), outside,
                              hull_mask))  # (C, H, W, B)
        vis = (~hit.any(dim=-1)).to(torch.float32)
        lit = lit + (light_weights[ks, None, None] * vis).sum(dim=0)
    ratio = lit / torch.clamp(light_weights.sum(), min=1e-9)
    if scale > 1:
        ratio = F.interpolate(ratio[None, None], size=tuple(full_hw),
                              mode="bilinear", align_corners=False,
                              antialias=False)[0, 0]
    return ratio


def hull_object_weight(
    cam: Camera,
    scene_depth: torch.Tensor,  # (H, W) normalized front-surface depth
    hull_planes: torch.Tensor,  # (B, F, 4) world-frame planes
    hull_mask: torch.Tensor,  # (B, F)
    depth_tol: float = 0.05,
    pad=0.0,
) -> torch.Tensor:
    """(H, W) 0/1 object-visibility weight by hull projection: a pixel
    shows an inserted object iff its view ray enters a hull (grown by
    ``pad``) before the merged scene surface, within a loose depth
    tolerance.  The camera is every ray's origin, so each plane's slack
    is one number per hull."""
    rays = cam.ray_directions()  # t along these rays is view z
    w = torch.zeros(scene_depth.shape, dtype=torch.float32,
                    device=scene_depth.device)
    for b in range(hull_planes.shape[0]):
        n = hull_planes[b, :, :3]
        d = hull_planes[b, :, 3] + pad
        dist = d - n @ cam.center  # (F,)
        denom = torch.einsum("hwi,fi->hwf", rays, n)
        t_exit, t_enter = _interval(denom, dist / denom, dist < 0,
                                    hull_mask[b])
        t_enter = torch.clamp(t_enter, min=0.0)
        hit = _hit(t_exit, t_enter)
        visible = hit & (t_enter <= scene_depth * (1.0 + depth_tol)
                         + depth_tol)
        w = torch.maximum(w, visible.to(torch.float32))
    return w


def object_hulls_world(shape, state):
    """(B, F, 4) world planes and (B, F) masks from the physics hulls and
    a body state."""
    rot = quat_to_rotmat(state.quat)
    n_w = torch.einsum("bij,bfj->bfi", rot, shape.planes[..., :3])
    d_w = shape.planes[..., 3] + torch.einsum("bfi,bi->bf", n_w, state.pos)
    return torch.cat([n_w, d_w[..., None]], dim=-1), shape.plane_mask
