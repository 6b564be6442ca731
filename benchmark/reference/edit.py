"""Plain PyTorch edited frame: the merged render of the background and
the IBL-shaded cube, its hull object weight and shadow ratio, and the
composite.

A frozen copy of the program's plain paths (``render/clip``'s fused
frame, ``render/ibl``'s shading without a GGX stack, ``render/envmap``'s
importance-sampled lights, ``render/meshsplat``'s surfel splats,
``render/shadow``'s slab tests) with no import of the program.  Every
input the program derives (the lights, the envmap's SH, the shaded
surfels, the world hulls, the shadow) is worked out again here from the
benchmark's own inputs: the envmap, the surfels, the hull planes and the
cube's poses.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import raster

DEPTH_ALPHA = 0.01
NO_DEPTH = 1e9
BIG = 1e30
PARALLEL = 1e-9
SHADOW_BIAS = 1e-2
DEPTH_TOL = 0.05
SURFEL_OPACITY = 0.95
FLAT_RATIO = 0.1
_A = (math.pi, 2.094395, 2.094395, 2.094395, 0.785398, 0.785398, 0.785398,
      0.785398, 0.785398)


# ---- the envmap --------------------------------------------------------------


def uv_to_direction(uv: torch.Tensor) -> torch.Tensor:
    u, v = uv.unbind(-1)
    theta = v * math.pi
    phi = (u - 0.5) * 2.0 * math.pi
    st = torch.sin(theta)
    return torch.stack([-st * torch.cos(phi), -st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def direction_to_uv(dirs: torch.Tensor) -> torch.Tensor:
    x, y, z = dirs.unbind(-1)
    theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
    phi = torch.atan2(-y, -x)
    return torch.stack([phi / (2.0 * math.pi) + 0.5, theta / math.pi], -1)


def texel_directions(h: int, w: int) -> np.ndarray:
    uu, vv = np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h)
    uv = torch.tensor(np.stack([uu, vv], -1), dtype=torch.float32)
    return uv_to_direction(uv).numpy()


def _sh9_basis(x, y, z, lib):
    return lib.stack([0.282095 * lib.ones_like(x), 0.488603 * y,
                      0.488603 * z, 0.488603 * x, 1.092548 * x * y,
                      1.092548 * y * z, 0.315392 * (3 * z * z - 1),
                      1.092548 * x * z, 0.546274 * (x * x - y * y)], -1)


def env_sh9(env: np.ndarray) -> np.ndarray:
    """(9, 3) SH projection of an equirect map."""
    h, w, _ = env.shape
    dirs = texel_directions(h, w)
    basis = _sh9_basis(dirs[..., 0], dirs[..., 1], dirs[..., 2], np)
    vv = np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h)[1]
    d_omega = (2 * np.pi / w) * (np.pi / h) * np.sin(vv * np.pi)
    return np.einsum("hwk,hwc,hw->kc", basis, env, d_omega).astype(np.float32)


def lights(env: np.ndarray, num: int) -> tuple[np.ndarray, np.ndarray]:
    """(dirs (L, 3), weights (L,)): luminance × solid angle × catcher
    cosine about +z, stratified inverse-CDF draws (seed 0), one light a
    texel drawn (its weights added)."""
    h, w, _ = env.shape
    up = np.array([0.0, 0.0, 1.0])
    sin_theta = np.sin((np.arange(h) + 0.5) / h * np.pi)[:, None]
    lum = env.sum(-1) * sin_theta
    cos_up = np.maximum(texel_directions(h, w).astype(np.float64) @ up, 0.0)
    dens = lum * cos_up.astype(np.float32)
    for cand in (dens, lum, np.broadcast_to(sin_theta, lum.shape)):
        total = cand.sum()
        if total > 0:
            dens = cand
            break
    p = dens.reshape(-1) / total
    rng = np.random.RandomState(0)
    cdf = np.cumsum(p)
    u = (np.arange(num) + rng.rand(num)) / num
    idx = np.minimum(np.searchsorted(cdf, u), len(p) - 1)
    idx, mult = np.unique(idx, return_counts=True)
    ys, xs = idx // w, idx % w
    uv = np.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1)
    dirs = uv_to_direction(torch.tensor(uv, dtype=torch.float32)).numpy()
    d_omega = (2 * np.pi / w) * (np.pi / h) * sin_theta.reshape(-1)[ys]
    pdf = p[idx] / np.maximum(d_omega, 1e-9)
    f = env.reshape(-1, 3)[idx] * np.maximum(dirs @ up, 0.0)[:, None]
    contrib = f * mult[:, None] / np.maximum(pdf[:, None], 1e-9) / num
    return dirs.astype(np.float32), contrib.astype(np.float32).sum(-1)


def sample_envmap(env: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    h, w, _ = env.shape
    uv = direction_to_uv(dirs)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    return (env[y0i, x0i] * (1 - fx) * (1 - fy) + env[y0i, x1i] * fx * (1 - fy)
            + env[y1i, x0i] * (1 - fx) * fy + env[y1i, x1i] * fx * fy)


def shade(n, view_dirs, env, sh, albedo, rough, metal):
    """albedo·E(n)/π + one mirror sample's Fresnel-weighted radiance."""
    v = -view_dirs
    ndv = torch.clamp(torch.sum(n * v, dim=-1, keepdim=True), min=0.0)
    refl = 2.0 * ndv * n - v
    basis = _sh9_basis(n[..., 0], n[..., 1], n[..., 2], torch)
    a = torch.tensor(_A, dtype=torch.float32, device=n.device)
    irr = torch.clamp(torch.einsum("...k,k,kc->...c", basis, a, sh)
                      / math.pi, min=0.0)
    f0 = 0.04 * (1.0 - metal) + metal * albedo
    fresnel = f0 + (1.0 - f0) * (1.0 - ndv) ** 5
    spec = sample_envmap(env, refl) * fresnel * (1.0 - 0.85 * rough)
    return albedo * irr * (1.0 - metal) + spec


# ---- the cube's surfels --------------------------------------------------------


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) -> (N, 4) wxyz, Shepperd's largest pivot."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    sq = lambda x: torch.sqrt(torch.clamp(x, min=1e-12))
    piv = [sq(1.0 + tr), sq(1.0 + m00 - m11 - m22), sq(1.0 - m00 + m11 - m22),
           sq(1.0 - m00 - m11 + m22)]
    rows = [[piv[0], m21 - m12, m02 - m20, m10 - m01],
            [m21 - m12, piv[1], m01 + m10, m02 + m20],
            [m02 - m20, m01 + m10, piv[2], m12 + m21],
            [m10 - m01, m02 + m20, m12 + m21, piv[3]]]
    cands = []
    for i, row in enumerate(rows):
        q = torch.stack(row, dim=-1) / (2.0 * row[i][..., None])
        q[..., i] = piv[i] / 2.0
        cands.append(q)
    cand = torch.stack(cands, dim=-2)
    best = torch.argmax(torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                                     m22 - m00 - m11], -1), -1)
    q = torch.take_along_dim(cand, best[..., None, None].expand(
        *best.shape, 1, 4), dim=-2)[..., 0, :]
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)


class Clip(NamedTuple):
    """The edit's inputs, as the benchmark made them, on the device."""

    points: torch.Tensor  # (S, 3) body frame
    normals: torch.Tensor  # (S, 3)
    albedo: torch.Tensor  # (S, 3): grey × the material's rgb
    radius: float
    rough: float
    metal: float
    pos: torch.Tensor  # (F, 1, 3)
    rot: torch.Tensor  # (F, 1, 3, 3)
    planes: torch.Tensor  # (1, P, 4) body frame
    mask: torch.Tensor  # (1, P) bool
    env: torch.Tensor  # (H, W, 3)
    env_sh: torch.Tensor  # (9, 3)
    light_dirs: torch.Tensor  # (L, 3)
    light_weights: torch.Tensor  # (L,)


def make_clip(surf: dict, material: dict, pos, rot, planes, mask,
              env: np.ndarray, num_lights: int, device) -> Clip:
    t = lambda a, dt=torch.float32: torch.as_tensor(
        np.asarray(a), dtype=dt, device=device)
    dirs, weights = lights(env, num_lights)
    return Clip(points=surf["points"].float(), normals=surf["normals"].float(),
                albedo=surf["colors"].float() * t(material["rgb"]),
                radius=float(surf["radius"]), rough=material["roughness"],
                metal=material["metallic"], pos=t(pos), rot=t(rot),
                planes=t(planes), mask=t(mask, torch.bool), env=t(env),
                env_sh=t(env_sh9(env)), light_dirs=t(dirs),
                light_weights=t(weights))


def object_gaussians(clip: Clip, i: int, cam: raster.Cam) -> dict:
    """The cube's surfels at frame ``i``'s pose, shaded for ``cam``, as
    flat normal-aligned splats (DC color only)."""
    r, p = clip.rot[i, 0], clip.pos[i, 0]
    pw = clip.points @ r.T + p
    nw = clip.normals @ r.T
    view = pw - cam.center[None]
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True),
                              min=1e-12)
    n = torch.where(torch.sum(nw * view, -1, keepdim=True) > 0, -nw, nw)
    color = shade(n, view, clip.env, clip.env_sh, clip.albedo, clip.rough,
                  clip.metal)
    nrm = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                          min=1e-12)
    c = (torch.abs(nrm[:, 2]) < 0.9).to(nrm.dtype)
    helper = torch.stack([1.0 - c, torch.zeros_like(c), c], dim=-1)
    t1 = torch.linalg.cross(helper, nrm, dim=-1)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True),
                          min=1e-12)
    t2 = torch.linalg.cross(nrm, t1, dim=-1)
    s = pw.shape[0]
    scales = pw.new_tensor([clip.radius, clip.radius,
                            clip.radius * FLAT_RATIO]).expand(s, 3)
    op = float(np.log(SURFEL_OPACITY / (1 - SURFEL_OPACITY)))
    return {"xyz": pw, "sh_dc": (color - 0.5) / raster.SH_C0,
            "sh_rest": pw.new_zeros((s, 15, 3)),
            "log_scales": torch.log(scales),
            "quats": rotmat_to_quat(torch.stack([t1, t2, nrm], dim=-1)),
            "opacity_logit": pw.new_full((s,), op),
            "active": torch.ones(s, dtype=torch.bool, device=pw.device)}


# ---- hulls and shadows --------------------------------------------------------


def world_planes(clip: Clip, i: int) -> torch.Tensor:
    rot, pos = clip.rot[i], clip.pos[i]
    n_w = torch.einsum("bij,bfj->bfi", rot, clip.planes[..., :3])
    d_w = clip.planes[..., 3] + torch.einsum("bfi,bi->bf", n_w, pos)
    return torch.cat([n_w, d_w[..., None]], dim=-1)


def rays(cam: raster.Cam) -> torch.Tensor:
    """(H, W, 3) world directions through the pixel centers, unit view z."""
    dev = cam.R.device
    j, i = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(cam.width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    d = [(i - cam.cx) / cam.fx, (j - cam.cy) / cam.fy, torch.ones_like(i)]
    R = cam.R
    return torch.stack([d[0] * R[0, k] + d[1] * R[1, k] + d[2] * R[2, k]
                        for k in range(3)], dim=-1)


def _interval(denom, t_plane, outside, mask):
    exits = (denom > PARALLEL) & mask
    enters = (denom < -PARALLEL) & mask
    t_exit = torch.where(exits, t_plane, BIG).amin(dim=-1)
    t_enter = torch.where(enters, t_plane, -BIG).amax(dim=-1)
    never = (mask & ~(exits | enters) & outside).any(dim=-1)
    return torch.where(never, -BIG, t_exit), t_enter


def _hit(t_exit, t_enter):
    return (t_exit > torch.clamp(t_enter, min=1e-4)) & (t_exit > 0)


def object_weight(cam, scene_depth, planes, mask, pad: float):
    """1 where the pixel's ray enters a hull grown by ``pad`` before the
    scene surface (within the depth tolerance), else 0."""
    r = rays(cam)
    w = torch.zeros(scene_depth.shape, device=scene_depth.device)
    for b in range(planes.shape[0]):
        n, d = planes[b, :, :3], planes[b, :, 3] + pad
        dist = d - n @ cam.center
        denom = torch.einsum("hwi,fi->hwf", r, n)
        t_exit, t_enter = _interval(denom, dist / denom, dist < 0, mask[b])
        t_enter = torch.clamp(t_enter, min=0.0)
        vis = _hit(t_exit, t_enter) & (
            t_enter <= scene_depth * (1.0 + DEPTH_TOL) + DEPTH_TOL)
        w = torch.maximum(w, vis.to(torch.float32))
    return w


def _box_down(x, scale: int, hs: int, ws: int):
    h2, w2 = hs * scale, ws * scale
    pad = (0, max(w2 - x.shape[1], 0), 0, max(h2 - x.shape[0], 0))
    if any(pad):
        x = F.pad(x[None, None], pad, mode="replicate")[0, 0]
    return x[:h2, :w2].reshape(hs, scale, ws, scale).mean(dim=(1, 3))


def shadow_ratio(cam, depth, alpha, dirs, weights, planes, mask, scale: int):
    """(H, W) lit share of the lights' weight at each background point
    (the slab test of each light ray against every hull), evaluated on a
    grid ``scale`` times coarser and upsampled bilinearly."""
    full_hw = depth.shape
    if scale > 1:
        cam = cam._replace(fx=cam.fx / scale, fy=cam.fy / scale,
                           cx=cam.cx / scale, cy=cam.cy / scale,
                           width=round(cam.width / scale),
                           height=round(cam.height / scale))
        depth = _box_down(depth, scale, cam.height, cam.width)
        alpha = _box_down(alpha, scale, cam.height, cam.width)
    z = depth / torch.clamp(alpha, min=1e-6)
    r = rays(cam)
    pts = cam.center[None, None] + r * z[..., None] - SHADOW_BIAS * r
    nrm, dvec = planes[..., :3], planes[..., 3]
    lit = torch.zeros(pts.shape[:2], device=pts.device)
    for k in range(dirs.shape[0]):
        denom = torch.einsum("i,bfi->bf", dirs[k], nrm)
        dist = dvec[None, None] - torch.einsum("hwi,bfi->hwbf", pts, nrm)
        inv = 1.0 / torch.where(torch.abs(denom) > PARALLEL, denom,
                                torch.full_like(denom, PARALLEL))
        hit = _hit(*_interval(denom, dist * inv, dist < 0, mask))
        lit = lit + weights[k] * (~hit.any(dim=-1)).to(torch.float32)
    ratio = lit / torch.clamp(weights.sum(), min=1e-9)
    if scale > 1:
        ratio = F.interpolate(ratio[None, None], size=tuple(full_hw),
                              mode="bilinear", align_corners=False)[0, 0]
    return ratio


def frame(bg: dict, clip: Clip, i: int, cam: raster.Cam, tile: int,
          shadow_scale: int, lowp: bool = False, counts: bool = False):
    """Edited frame ``i``: (H, W, 3) in [0, 1] (and the merged render's
    ``raster.Counts`` when asked)."""
    obj = object_gaussians(clip, i, cam)
    out = raster.render([bg, obj], cam, tile, lowp=lowp, counts=counts)
    img, c = out if counts else (out, None)
    alpha = torch.clamp(img.alpha, 0.0, 1.0)
    scene_depth = torch.where(alpha > DEPTH_ALPHA,
                              img.depth / torch.clamp(alpha, min=1e-6),
                              torch.full_like(alpha, NO_DEPTH))
    planes = world_planes(clip, i)
    w_obj = object_weight(cam, scene_depth, planes, clip.mask,
                          3.0 * clip.radius)
    ratio = torch.clamp(shadow_ratio(
        cam, img.depth, torch.clamp(alpha, min=1e-3), clip.light_dirs,
        clip.light_weights, planes, clip.mask, shadow_scale), 0.0, 1.0)
    mult = 1.0 - (1.0 - ratio) * (1.0 - w_obj) * alpha
    mult = torch.where(torch.abs(ratio - 1.0) >= 0.01, mult,
                       torch.ones_like(mult))
    out_img = torch.clamp(img.color * mult[..., None], 0.0, 1.0)
    return (out_img, c) if counts else out_img


def objects(clip: Clip, i: int, cam: raster.Cam) -> list:
    """Frame ``i``'s object sets (for the merged render's need)."""
    return [object_gaussians(clip, i, cam)]
