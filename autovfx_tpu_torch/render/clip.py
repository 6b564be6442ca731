"""Edited-clip rendering: physics replay, object shading, shadows and the
composite of every frame, on the device.

Counterpart of ``autovfx_tpu/render/clip.py``.  Per frame:

1. the inserted objects' surfels moved by the rigid trajectory and
   IBL-shaded (``shaded_object_gaussians``);
2. either one merged render of the background and object sets
   (``render_edited_frame_fused``: ``ops.rasterize.rasterize_multi``,
   kernels 1-3) with an analytic object weight from the hulls, or two
   renders and the compositor (``render_edited_frame``);
3. the envmap-visibility shadow ratio against the objects' hulls;
4. the composite.

The merged render is exact float32 (the JAX package's fused frame needs
its bf16 Pallas feature pack), so the port's fused frame also runs on
CPU tensors, through the kernels' plain versions.

Not ported here: the smoke, fire and liquid-melt inputs of the JAX
``ClipInputs`` and ``smoke_cfg`` (effects, a later slice: they raise
``NotImplementedError``), and ``pack_rows`` / ``bg_rows`` (the TPU's
scene-rows layout, which the merged render does not need).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.cameras import Camera, index_camera
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.ops.rasterize import (
    RasterConfig,
    RenderOutput,
    rasterize,
    rasterize_multi,
)
from autovfx_tpu_torch.render import composite as RCOMP
from autovfx_tpu_torch.render import ibl as RIBL
from autovfx_tpu_torch.render import meshsplat as RMS
from autovfx_tpu_torch.render import shadow as RSH
from autovfx_tpu_torch.utils.gather import take

EFFECTS_SLICE = ("smoke, fire and liquid melt are the effects slice "
                 "(queue 1 slice 6 of ROADMAP.md), not ported yet")

DEPTH_ALPHA = 0.01  # coverage below which a pass has no depth (1e9)
NO_DEPTH = 1e9


@dataclasses.dataclass(frozen=True)
class ClipInputs:
    """The tensors the frame loop reads, on one device."""

    bg: Gaussians
    cams: Camera  # stacked (F)
    # object surfels, concatenated over objects (S in all)
    surf_points: torch.Tensor  # (S, 3) object-local
    surf_normals: torch.Tensor  # (S, 3)
    surf_colors: torch.Tensor  # (S, 3) albedo
    surf_radius: torch.Tensor  # (S,)
    surf_body: torch.Tensor  # (S,) int64 body index
    surf_rough: torch.Tensor  # (S,)
    surf_metal: torch.Tensor  # (S,)
    # per-frame rigid transforms (mesh origin), and per-body scale
    traj_pos: torch.Tensor  # (F, B, 3)
    traj_rot: torch.Tensor  # (F, B, 3, 3)
    traj_scale: torch.Tensor  # (B,)
    # hulls for the shadows, body frame
    hull_planes: torch.Tensor  # (B, Fh, 4)
    hull_mask: torch.Tensor  # (B, Fh)
    # lighting
    env: torch.Tensor  # (He, We, 3)
    env_sh: torch.Tensor  # (9, 3)
    light_dirs: torch.Tensor  # (L, 3)
    light_weights: torch.Tensor  # (L,)
    env_ggx: Optional[torch.Tensor] = None  # (levels, H, W, 3)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def build_clip_inputs(
    bg: Gaussians,
    cams: Camera,
    objects: list,
    surfels: list,
    traj_pos,
    traj_rot,
    hull_shape,
    env: np.ndarray,
    num_lights: int = 32,
    smoke_traj=None,
    melt: Optional[dict] = None,
    with_ggx: bool = False,
    device=devices.DEFAULT,
) -> ClipInputs:
    """Assemble the clip's inputs on ``device`` from edit-IR object dicts,
    their surfel dicts (``sample_mesh_surfels``, numpy or tensors), the
    trajectory (F, B, 3) / (F, B, 3, 3), the physics hulls (anything
    with ``planes`` and ``plane_mask``) and the envmap.  ``bg`` and
    ``cams`` are used as they are."""
    device = devices.resolve(device)
    if smoke_traj is not None or melt is not None:
        raise NotImplementedError(f"build_clip_inputs: {EFFECTS_SLICE}")
    pts, nrm, col, rad, body, rough, metal = [], [], [], [], [], [], []
    for i, (obj, s) in enumerate(zip(objects, surfels)):
        s = {k: _numpy(v) for k, v in s.items()}
        mat = obj.get("material") or {}
        base = mat.get("rgb")
        if mat.get("material_path"):
            from autovfx_tpu_torch.render import materials as RMAT

            material = RMAT.load_material_folder(mat["material_path"])
            s = RMAT.apply_material_to_surfels(s, material)
            if base is not None:  # rgb + texture: a hue-shift recolor
                s = dict(s)
                s["colors"] = RMAT.hue_shift_colors(s["colors"], base)
            base = None
        n = len(s["points"])
        c = s["colors"] if base is None else s["colors"] * np.asarray(base)
        pts.append(s["points"])
        nrm.append(s["normals"])
        col.append(c)
        rad.append(np.full(n, s["radius"], np.float32))
        body.append(np.full(n, i, np.int64))
        if "roughness" in s:
            rough.append(np.asarray(s["roughness"], np.float32))
        else:
            rough.append(np.full(n, float(mat.get("roughness", 0.5)),
                                 np.float32))
        metal.append(np.full(
            n, 1.0 if mat.get("is_mirror") else float(mat.get("metallic",
                                                              0.0)),
            np.float32))
    # catcher-cosine lights, stratified and deduplicated (+z is the
    # scene's up): the shadow ratio then estimates the white-catcher
    # quotient
    dirs, contrib = clip_lights(env, num_lights)
    hull_planes, hull_mask = RSH.trim_hull_planes(
        _numpy(hull_shape.planes), _numpy(hull_shape.plane_mask))
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt,
                                                 device=device)
    env = np.asarray(env, np.float32)
    return ClipInputs(
        bg=bg,
        cams=cams,
        surf_points=t(np.concatenate(pts)),
        surf_normals=t(np.concatenate(nrm)),
        surf_colors=t(np.concatenate(col).astype(np.float32)),
        surf_radius=t(np.concatenate(rad)),
        surf_body=t(np.concatenate(body), torch.int64),
        surf_rough=t(np.concatenate(rough)),
        surf_metal=t(np.concatenate(metal)),
        traj_pos=t(_numpy(traj_pos).astype(np.float32)),
        traj_rot=t(_numpy(traj_rot).astype(np.float32)),
        traj_scale=t(np.array([float(o.get("scale", 1.0)) for o in objects],
                              np.float32)),
        hull_planes=t(hull_planes),
        hull_mask=t(hull_mask, torch.bool),
        env=t(env),
        env_sh=t(RIBL.envmap_sh9(env)),
        light_dirs=t(dirs),
        light_weights=t(contrib.sum(-1)),
        env_ggx=(t(RIBL.prefilter_envmap_ggx(env, device=device))
                 if with_ggx else None),
    )


def clip_lights(env: np.ndarray, num_lights: int):
    """The clip's shadow lights: ``envmap.importance_directions`` with the
    catcher cosine about +z, stratified and deduplicated."""
    from autovfx_tpu_torch.render.envmap import importance_directions

    return importance_directions(env, num_lights, up=np.array([0.0, 0.0, 1.0]),
                                 stratified=True, dedup=True)


def shaded_object_gaussians(inp: ClipInputs, frame_idx, cam: Camera) -> Gaussians:
    """IBL-shaded object surfels at this frame's rigid poses, as flat
    normal-aligned splats with per-surfel radii."""
    rot = inp.traj_rot[frame_idx]  # (B, 3, 3)
    pos = inp.traj_pos[frame_idx]  # (B, 3)
    s = take(inp.traj_scale, inp.surf_body)[:, None]
    rb = take(rot, inp.surf_body)  # (S, 3, 3)
    p = inp.surf_points * s
    px, py, pz = p.unbind(-1)
    nx, ny, nz = inp.surf_normals.unbind(-1)
    p_world = torch.stack(
        [rb[:, i, 0] * px + rb[:, i, 1] * py + rb[:, i, 2] * pz
         for i in range(3)], dim=-1) + take(pos, inp.surf_body)
    n_world = torch.stack(
        [rb[:, i, 0] * nx + rb[:, i, 1] * ny + rb[:, i, 2] * nz
         for i in range(3)], dim=-1)
    view = p_world - cam.center[None]
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True),
                              min=1e-12)
    facing = torch.sum(n_world * view, -1, keepdim=True)
    n_shade = torch.where(facing > 0, -n_world, n_world)
    shaded = RIBL.shade(
        n_shade, view, inp.env, inp.env_sh, inp.surf_colors,
        roughness=inp.surf_rough[:, None], metallic=inp.surf_metal[:, None],
        env_ggx=inp.env_ggx,
    )
    g_obj = RMS.surfels_to_gaussians(p_world, n_shade, shaded, 1.0)
    scaled_r = inp.surf_radius * take(inp.traj_scale, inp.surf_body)
    return dataclasses.replace(g_obj, log_scales=torch.log(
        torch.stack([scaled_r, scaled_r, scaled_r * 0.1], dim=-1)))


def world_hull_planes_at(inp: ClipInputs, frame_idx) -> torch.Tensor:
    """(B, Fh, 4) world-frame hull planes at this frame's poses."""
    rot = inp.traj_rot[frame_idx]
    pos = inp.traj_pos[frame_idx]
    n_w = torch.einsum("bij,bfj->bfi", rot, inp.hull_planes[..., :3])
    d_w = inp.hull_planes[..., 3] * inp.traj_scale[:, None] + torch.einsum(
        "bfi,bi->bf", n_w, pos)
    return torch.cat([n_w, d_w[..., None]], dim=-1)


def pass_depth(out: RenderOutput, alpha: torch.Tensor) -> torch.Tensor:
    """A pass's normalized depth, 1e9 where it covers under 1 %."""
    depth = out.depth / torch.clamp(alpha, min=1e-6)
    return torch.where(alpha > DEPTH_ALPHA, depth,
                       torch.full_like(depth, NO_DEPTH))


def render_edited_frame(inp: ClipInputs, frame_idx,
                        config: RasterConfig) -> torch.Tensor:
    """One edited frame by two renders and the compositor (the
    reference semantics of ``blend_all.py``)."""
    cam = index_camera(inp.cams, frame_idx)

    bg_out = rasterize(inp.bg, cam, config=config)
    bg_alpha = torch.clamp(bg_out.alpha, 0.0, 1.0)
    scene_depth = pass_depth(bg_out, bg_alpha)

    g_obj = shaded_object_gaussians(inp, frame_idx, cam)
    obj_out = rasterize(g_obj, cam, config=config)
    obj_depth = pass_depth(obj_out, obj_out.alpha)

    planes_w = world_hull_planes_at(inp, frame_idx)
    ratio = RSH.shadow_ratio_map(
        cam, bg_out.depth, torch.clamp(bg_alpha, min=1e-3), inp.light_dirs,
        inp.light_weights, planes_w, inp.hull_mask)
    return RCOMP.composite_frame(RCOMP.CompositeInputs(
        bg_color=bg_out.color, scene_depth=scene_depth,
        obj_color=obj_out.color, obj_alpha=obj_out.alpha,
        obj_depth=obj_depth, shadow_ratio=ratio, catcher_alpha=bg_alpha,
    ))


def object_pad(inp: ClipInputs) -> torch.Tensor:
    """The hulls' outward growth for ``hull_object_weight``: three mean
    scaled surfel radii, the splats' bleed past the silhouette."""
    return 3.0 * torch.mean(inp.surf_radius
                            * take(inp.traj_scale, inp.surf_body))


def fused_composite(out: RenderOutput, ratio: torch.Tensor,
                    w_obj: torch.Tensor) -> torch.Tensor:
    """frame = C · (1 − (1 − ratio)·(1 − w_obj)·α) where the ratio is a
    real shadow (|ratio − 1| ≥ 0.01), clipped to [0, 1]."""
    alpha = torch.clamp(out.alpha, 0.0, 1.0)
    ratio = torch.clamp(ratio, 0.0, 1.0)
    is_shadow = torch.abs(ratio - 1.0) >= 0.01
    mult = 1.0 - (1.0 - ratio) * (1.0 - w_obj) * alpha
    mult = torch.where(is_shadow, mult, torch.ones_like(mult))
    return torch.clamp(out.color * mult[..., None], 0.0, 1.0)


def render_edited_frame_fused(
    inp: ClipInputs,
    frame_idx,
    config: RasterConfig,
    shadow_scale: int = 2,
    smoke_cfg=None,
) -> torch.Tensor:
    """One edited frame through one merged render of the background and
    the shaded object surfels: per-splat depth order resolves their
    occlusion.  The object weight comes from the hulls
    (``shadow.hull_object_weight``), so the shadow ratio darkens only the
    background's share of each pixel (``fused_composite``)."""
    if smoke_cfg is not None:
        raise NotImplementedError(
            f"render_edited_frame_fused(smoke_cfg=...): {EFFECTS_SLICE}")
    cam = index_camera(inp.cams, frame_idx)
    g_obj = shaded_object_gaussians(inp, frame_idx, cam)
    out = rasterize_multi([inp.bg, g_obj], cam, config=config)

    alpha = torch.clamp(out.alpha, 0.0, 1.0)
    scene_depth = pass_depth(out, alpha)
    planes_w = world_hull_planes_at(inp, frame_idx)
    w_obj = RSH.hull_object_weight(cam, scene_depth, planes_w, inp.hull_mask,
                                   pad=object_pad(inp))
    ratio = RSH.shadow_ratio_map(
        cam, out.depth, torch.clamp(alpha, min=1e-3), inp.light_dirs,
        inp.light_weights, planes_w, inp.hull_mask, scale=shadow_scale)
    return fused_composite(out, ratio, w_obj)


def render_clip(
    inp: ClipInputs,
    num_frames: int,
    config: RasterConfig,
    fused: bool = False,
    supersample: int = 1,
    smoke_cfg=None,
) -> torch.Tensor:
    """(F, H, W, 3) edited frames.  ``supersample`` > 1 (a power of 2)
    renders at that many times the resolution and box-filters down by
    halves."""
    if smoke_cfg is not None:
        raise NotImplementedError(f"render_clip(smoke_cfg=...): {EFFECTS_SLICE}")
    frame_fn = render_edited_frame_fused if fused else render_edited_frame
    if supersample > 1:
        c, f = inp.cams, supersample
        inp = dataclasses.replace(inp, cams=dataclasses.replace(
            c, fx=c.fx * f, fy=c.fy * f, cx=c.cx * f, cy=c.cy * f,
            width=c.width * f, height=c.height * f))
    frames = []
    for i in range(num_frames):
        f = frame_fn(inp, i, config)
        for _ in range(max(supersample, 1).bit_length() - 1):
            f = RCOMP.downsample2x(f)
        frames.append(f)
    return torch.stack(frames)
