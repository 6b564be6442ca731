"""Edited-clip rendering: physics replay, object shading, shadows, effects
and the composite of every frame, on the device.

Counterpart of ``autovfx_tpu/render/clip.py``.  Per frame:

1. the inserted objects' surfels moved by the rigid trajectory (or, where
   they melt, by the liquid's tracers) and IBL-shaded
   (``shaded_object_gaussians``);
2. either one merged render of the background, object and smoke sets
   (``render_edited_frame_fused``: ``ops.rasterize.rasterize_multi``,
   kernels 1-3) with an analytic object weight from the hulls, or two
   renders and the compositor (``render_edited_frame``);
3. the envmap-visibility shadow ratio against the objects' hulls;
4. the composite, and on the fused path the fire splats' own render
   added on top.

The merged render is exact float32 (the JAX package's fused frame needs
its bf16 Pallas feature pack), so the port's fused frame also runs on
CPU tensors, through the kernels' plain versions.  ``pack_rows`` and
``bg_rows`` (the TPU's scene-rows layout, which the merged render does
not need) are not ported.
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
from autovfx_tpu_torch.render import smoke as SMK
from autovfx_tpu_torch.utils import trace
from autovfx_tpu_torch.utils.gather import take

DEPTH_ALPHA = 0.01  # coverage below which a pass has no depth (1e9)
NO_DEPTH = 1e9
FIRE_BUDGET = 1 << 18  # the fire render's duplicate budget, at most


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
    # a smoke/fire volume (the whole clip's solver output): smoke splats
    # join the merged render, fire renders alone and is added
    smoke_density: Optional[torch.Tensor] = None  # (F, R, R, R)
    smoke_temp: Optional[torch.Tensor] = None  # (F, R, R, R)
    smoke_origin: Optional[torch.Tensor] = None  # (3,)
    smoke_extent: Optional[torch.Tensor] = None  # () float32
    # the adaptive domain's per-frame offsets in cells (zeros when fixed)
    smoke_origin_cells: Optional[torch.Tensor] = None  # (F, 3) int32
    # liquid-melt tracers: surfels in melt_mask take their world pose
    # from melt_pos / melt_norm[frame] instead of the rigid trajectory
    melt_pos: Optional[torch.Tensor] = None  # (F, S, 3)
    melt_norm: Optional[torch.Tensor] = None  # (F, S, 3)
    melt_mask: Optional[torch.Tensor] = None  # (S,) bool


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
    ``cams`` are used as they are.

    ``smoke_traj``: (states, origin, extent, smoke_cfg), or the same with
    the adaptive domain's per-frame origin cells (F, 3) fifth
    (``smoke.simulate_smoke``).  ``melt``: a dict of the tracers' ``pos``
    and ``norm`` (F, S, 3) and the melting surfels' ``mask`` (S,)."""
    device = devices.resolve(device)
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
    def t(a, dt=torch.float32):  # a tensor is moved, an array copied
        if torch.is_tensor(a):
            return a.to(device=device, dtype=dt)
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    env = np.asarray(env, np.float32)
    effects = {}
    if smoke_traj is not None:
        if len(smoke_traj) not in (4, 5):
            raise ValueError("smoke_traj is (states, origin, extent, "
                             "smoke_cfg[, origin_cells])")
        states, s_origin, s_extent = smoke_traj[:3]
        frames = states.density.shape[0]
        cells = (smoke_traj[4] if len(smoke_traj) == 5
                 else np.zeros((frames, 3), np.int32))
        effects.update(
            smoke_density=t(states.density), smoke_temp=t(states.temperature),
            smoke_origin=t(s_origin), smoke_extent=t(s_extent),
            smoke_origin_cells=t(cells, torch.int32))
    if melt is not None:
        effects.update(melt_pos=t(melt["pos"]), melt_norm=t(melt["norm"]),
                       melt_mask=t(melt["mask"], torch.bool))
    return ClipInputs(
        **effects,
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
    if inp.melt_pos is not None:  # the liquid's tracers own melting surfels
        m = inp.melt_mask[:, None]
        p_world = torch.where(m, inp.melt_pos[frame_idx], p_world)
        n_world = torch.where(m, inp.melt_norm[frame_idx], n_world)
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
                    w_obj: torch.Tensor,
                    emission: Optional[torch.Tensor] = None) -> torch.Tensor:
    """frame = C · (1 − (1 − ratio)·(1 − w_obj)·α) where the ratio is a
    real shadow (|ratio − 1| ≥ 0.01), plus ``emission`` (the fire pass's
    premultiplied color) when given, clipped to [0, 1]."""
    alpha = torch.clamp(out.alpha, 0.0, 1.0)
    ratio = torch.clamp(ratio, 0.0, 1.0)
    is_shadow = torch.abs(ratio - 1.0) >= 0.01
    mult = 1.0 - (1.0 - ratio) * (1.0 - w_obj) * alpha
    mult = torch.where(is_shadow, mult, torch.ones_like(mult))
    frame = out.color * mult[..., None]
    if emission is not None:
        frame = frame + emission
    return torch.clamp(frame, 0.0, 1.0)


def smoke_gaussians(inp: ClipInputs, frame_idx,
                    smoke_cfg: Optional[SMK.SmokeConfig] = None):
    """(smoke, fire) splat sets of this frame's volume: the density with
    its display noise, at the domain's origin moved by the adaptive
    offset.  ``smoke_cfg`` gives the noise (the defaults when None; pass
    the simulation's own config to match its render)."""
    if smoke_cfg is None:
        smoke_cfg = SMK.SmokeConfig()
    origin = inp.smoke_origin
    if inp.smoke_origin_cells is not None:  # cells -> world units
        cell = inp.smoke_extent / inp.smoke_density.shape[1]
        origin = origin + (inp.smoke_origin_cells[frame_idx].to(torch.float32)
                           * cell)
    return SMK.smoke_fire_gaussians(
        SMK.apply_density_noise(inp.smoke_density[frame_idx], frame_idx,
                                smoke_cfg),
        inp.smoke_temp[frame_idx], origin, inp.smoke_extent)


def fire_config(config: RasterConfig) -> RasterConfig:
    """The fire render's config: the frame's, with a duplicate budget of
    at most ``FIRE_BUDGET``."""
    return dataclasses.replace(config, dup_budget=min(config.dup_budget,
                                                      FIRE_BUDGET))


def render_edited_frame_fused(
    inp: ClipInputs,
    frame_idx,
    config: RasterConfig,
    shadow_scale: int = 2,
    smoke_cfg: Optional[SMK.SmokeConfig] = None,
) -> torch.Tensor:
    """One edited frame through one merged render of the background, the
    shaded object surfels and (with a smoke volume) the smoke splats:
    per-splat depth order resolves their occlusion.  The object weight
    comes from the hulls (``shadow.hull_object_weight``), so the shadow
    ratio darkens only the background's share of each pixel
    (``fused_composite``).  The fire splats render alone, so that their
    own alpha decides their occlusion, and their color (premultiplied
    over black) is added to the frame."""
    with trace.span("frame"):
        cam = index_camera(inp.cams, frame_idx)
        with trace.span("frame.shading"):
            shaded = shaded_object_gaussians(inp, frame_idx, cam)
        sets = [inp.bg, shaded]
        g_fire = None
        if inp.smoke_density is not None:
            with trace.span("frame.smoke"):
                g_smoke, g_fire = smoke_gaussians(inp, frame_idx, smoke_cfg)
            if trace.enabled():
                trace.count_device("smoke.splats", g_smoke.active.sum())
                trace.count("smoke.slots", g_smoke.capacity)
            sets.append(g_smoke)
        out = rasterize_multi(sets, cam, config=config)

        alpha = torch.clamp(out.alpha, 0.0, 1.0)
        scene_depth = pass_depth(out, alpha)
        with trace.span("frame.shadow"):
            planes_w = world_hull_planes_at(inp, frame_idx)
            w_obj = RSH.hull_object_weight(cam, scene_depth, planes_w,
                                           inp.hull_mask, pad=object_pad(inp))
            ratio = RSH.shadow_ratio_map(
                cam, out.depth, torch.clamp(alpha, min=1e-3), inp.light_dirs,
                inp.light_weights, planes_w, inp.hull_mask,
                scale=shadow_scale)
        fire = None
        if g_fire is not None:
            with trace.span("frame.fire"):
                fire = rasterize(g_fire, cam, config=fire_config(config)).color
        return fused_composite(out, ratio, w_obj, fire)


def render_clip(
    inp: ClipInputs,
    num_frames: int,
    config: RasterConfig,
    fused: bool = False,
    supersample: int = 1,
    smoke_cfg: Optional[SMK.SmokeConfig] = None,
) -> torch.Tensor:
    """(F, H, W, 3) edited frames.  ``supersample`` > 1 (a power of 2)
    renders at that many times the resolution and box-filters down by
    halves.  The smoke and fire render on the fused path only, with
    ``smoke_cfg``'s display noise."""
    if fused:
        frame_fn = lambda inp, i, config: render_edited_frame_fused(
            inp, i, config, smoke_cfg=smoke_cfg)
    else:
        frame_fn = render_edited_frame
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
