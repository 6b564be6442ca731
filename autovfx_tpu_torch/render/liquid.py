"""Height-field liquid solve for melting objects.

Counterpart of ``autovfx_tpu/render/liquid.py``: a thin-film
(lubrication) height field on a fixed 2D grid,

    ∂h/∂t = ∇·( (h³/3ν) ∇(h + b) ) + source,

in explicit flux form with the donor cell's depth and a flux limiter
that never drains a cell below zero, so volume is conserved on the
closed domain.  The melting object feeds the film through its footprint
as the melt progresses; its surfels ride the film as tracers advected
by the depth-averaged velocity u = -(h²/3ν)∇η, and per-frame surface
meshes are triangulated on the host (``frame_mesh``).

The clip's frames and each frame's substeps are Python loops of tensor
operations on the sim's device that read nothing back.  The flux
divergence is accumulated by slice additions into a zeros tensor, in
the JAX package's order: deterministic, unlike a scatter-add.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.utils.gather import take


class LiquidConfig(NamedTuple):
    resolution: int = 128  # height-field cells per axis (2D grid)
    viscosity: float = 2e-3  # kinematic-ish ν
    substeps: int = 16  # solver substeps per frame
    dt: float = 1.0 / 24.0  # frame time
    margin: float = 1.6  # domain half-extent / object radius
    min_depth: float = 1e-5  # dry-cell threshold


class MeltFrames(NamedTuple):
    """Per-frame solver outputs (leading axis F = frames)."""

    h: torch.Tensor  # (F, R, R) fluid thickness
    eta: torch.Tensor  # (F, R, R) free surface height (bed + h)
    tracer_pos: torch.Tensor  # (F, P, 3) tracer positions
    tracer_norm: torch.Tensor  # (F, P, 3) tracer normals
    tracer_fluid: torch.Tensor  # (F, P) float 0/1: the tracer has melted
    volume: torch.Tensor  # (F,) total fluid volume


def _bilinear(field: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample an (R, R) field at fractional grid coords xy (P, 2)."""
    r = field.shape[0]
    p = torch.clamp(xy, 0.0, r - 1.001)
    i0 = torch.floor(p)
    f = p - i0
    i0 = i0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=r - 1)
    flat = field.reshape(-1)
    at = lambda ix, iy: take(flat, ix * r + iy)
    c00 = at(i0[:, 0], i0[:, 1])
    c10 = at(i1[:, 0], i0[:, 1])
    c01 = at(i0[:, 0], i1[:, 1])
    c11 = at(i1[:, 0], i1[:, 1])
    c0 = c00 * (1 - f[:, 0]) + c10 * f[:, 0]
    c1 = c01 * (1 - f[:, 0]) + c11 * f[:, 0]
    return c0 * (1 - f[:, 1]) + c1 * f[:, 1]


def _substep(h, bed, source, cell: float, cfg: LiquidConfig):
    """One explicit thin-film update; returns (h_new, u (R, R, 2))."""
    dt = cfg.dt / cfg.substeps
    inv_c = 1.0 / cell
    h = h + source  # volume injection (already per substep)
    eta = bed + h

    def face_flux(axis):
        # the face's diffusivity from the donor (higher-η) side, so a
        # dry cell cannot emit flux and wetting fronts advance monotonically
        if axis == 0:
            deta = (eta[1:, :] - eta[:-1, :]) * inv_c  # (R-1, R)
            h_lo, h_hi = h[:-1, :], h[1:, :]
        else:
            deta = (eta[:, 1:] - eta[:, :-1]) * inv_c  # (R, R-1)
            h_lo, h_hi = h[:, :-1], h[:, 1:]
        h_up = torch.where(deta > 0, h_hi, h_lo)
        # clamped at the explicit stability limit
        d_stab = 0.9 * cell * cell / (4.0 * dt)
        d = torch.clamp(h_up * h_up * h_up / (3.0 * cfg.viscosity),
                        max=d_stab)
        flux = d * deta
        # limiter: a face drains at most the donor's share of its depth
        cap = h_up * cell / (4.0 * dt)
        return torch.clamp(flux, -cap, cap)

    fx = face_flux(0)  # flux from cell i+1 to i where positive
    fy = face_flux(1)
    div = torch.zeros_like(h)
    div[:-1, :] += fx
    div[1:, :] -= fx
    div[:, :-1] += fy
    div[:, 1:] -= fy
    h_new = torch.clamp(h + dt * inv_c * div, min=0.0)

    # depth-averaged velocity at the cell centers, for the tracers: a
    # positive face flux moves volume toward the lower index
    ux = torch.zeros_like(h)
    ux[:-1, :] += 0.5 * fx
    ux[1:, :] += 0.5 * fx
    uy = torch.zeros_like(h)
    uy[:, :-1] += 0.5 * fy
    uy[:, 1:] += 0.5 * fy
    hd = torch.clamp(h_new, min=cfg.min_depth)
    return h_new, torch.stack([-ux / hd, -uy / hd], dim=-1)


class MeltSim:
    """Whole-clip melt solve for one object (surfels or splat centers).

    ``points``/``normals``: the object's sample points (world scale,
    already posed).  ``bed``: optional (R, R) scene height map over the
    domain (default: flat at ``ground_z``); ``bed_from_mesh`` builds one
    from scene geometry.  The solve runs on ``device``."""

    def __init__(
        self,
        points: np.ndarray,
        normals: Optional[np.ndarray] = None,
        ground_z: Optional[float] = None,
        bed: Optional[np.ndarray] = None,
        cfg: LiquidConfig = LiquidConfig(),
        device=devices.DEFAULT,
    ):
        self.device = devices.resolve(device)
        pts = np.asarray(points, np.float32)
        self.cfg = cfg
        r = cfg.resolution
        center = pts[:, :2].mean(0)
        radius = float(np.max(np.linalg.norm(pts[:, :2] - center[None],
                                             axis=1)))
        radius = max(radius, 1e-3)
        self.extent = 2.0 * cfg.margin * radius
        self.origin = center - 0.5 * self.extent  # (2,)
        self.cell = self.extent / r
        if ground_z is None:
            ground_z = float(pts[:, 2].min())
        self.ground_z = ground_z
        if bed is None:
            bed = np.zeros((r, r), np.float32)
        t = lambda a: torch.tensor(np.asarray(a, np.float32),
                                   device=self.device)
        self.bed = t(bed)
        self.points = t(pts)
        self.normals = t(normals if normals is not None
                         else np.tile([0, 0, 1.0], (len(pts), 1)))
        # object volume estimate: footprint area × mean height
        h_obj = pts[:, 2] - ground_z
        self.height = float(max(h_obj.max(), 1e-4))
        cells = self._cell_of(pts)
        occ = np.zeros((r, r), np.float32)
        np.add.at(occ, (cells[:, 0], cells[:, 1]), 1.0)
        self.footprint = t(occ > 0)
        n_cells = float(max(np.sum(occ > 0), 1.0))
        self.volume = 0.6 * n_cells * self.cell**2 * self.height

    def _cell_of(self, pts: np.ndarray) -> np.ndarray:
        r = self.cfg.resolution
        gx = np.clip((pts[:, 0] - self.origin[0]) / self.cell, 0,
                     r - 1).astype(np.int32)
        gy = np.clip((pts[:, 1] - self.origin[1]) / self.cell, 0,
                     r - 1).astype(np.int32)
        return np.stack([gx, gy], -1)

    def run(self, progress) -> MeltFrames:
        """Solve the clip.  ``progress``: (F,) melt progress per frame
        (non-decreasing, in [0, 1])."""
        cfg = self.cfg
        r = cfg.resolution
        dev = self.device
        prog = torch.as_tensor(np.asarray(progress, np.float32), device=dev)
        dprog = prog - torch.cat([torch.zeros(1, device=dev), prog[:-1]])
        foot_w = self.footprint / torch.clamp(torch.sum(self.footprint),
                                              min=1.0)
        cell = self.cell
        origin = torch.as_tensor(np.asarray(self.origin, np.float32),
                                 device=dev)
        pts0, nrm0, bed = self.points, self.normals, self.bed
        h_rel = (pts0[:, 2] - self.ground_z) / self.height  # 0..1
        inv_c = 1.0 / cell

        h = torch.zeros((r, r), device=dev)
        txy = torch.clamp((pts0[:, :2] - origin[None]) / cell, 0.0,
                          r - 1.001)
        outs = []
        for f in range(prog.shape[0]):
            p_f, dp = prog[f], dprog[f]
            # volume melted this frame, injected over the substeps
            src = (dp * self.volume / cell**2 / cfg.substeps) * foot_w
            for _ in range(cfg.substeps):
                h, u = _substep(h, bed, src, cell, cfg)
                uxy = torch.stack([_bilinear(u[..., 0], txy),
                                   _bilinear(u[..., 1], txy)], -1)
                txy = txy + uxy * (cfg.dt / cfg.substeps) / cell
                txy = torch.clamp(txy, 0.0, r - 1.001)
            eta = bed + h

            # top-down melt: points above the solid's top have melted
            melted = (h_rel > (1.0 - p_f) + 1e-6) | (p_f >= 1.0)
            # the fluid part rides the surface at the advected xy; eta is
            # relative to the ground_z datum
            h_at = _bilinear(h, txy)
            eta_at = _bilinear(eta, txy)
            z_fluid = torch.where(h_at > cfg.min_depth,
                                  self.ground_z + eta_at - 0.25 * h_at,
                                  torch.full_like(h_at, self.ground_z))
            xy_fluid = origin[None] + (txy + 0.5) * cell
            pos = torch.cat([
                torch.where(melted[:, None], xy_fluid, pts0[:, :2]),
                torch.where(melted, z_fluid, pts0[:, 2])[:, None]], dim=-1)
            # fluid normals from the free-surface gradient
            gx = torch.gradient(eta, dim=0)[0] * inv_c
            gy = torch.gradient(eta, dim=1)[0] * inv_c
            nx = -_bilinear(gx, txy)
            ny = -_bilinear(gy, txy)
            n_fluid = torch.stack([nx, ny, torch.ones_like(nx)], -1)
            n_fluid = n_fluid / torch.sqrt(
                nx * nx + ny * ny + 1.0)[:, None]
            nrm = torch.where(melted[:, None], n_fluid, nrm0)
            vol = torch.sum(h) * cell**2
            outs.append((h, eta, pos, nrm, melted.to(torch.float32), vol))
        h, eta, pos, nrm, fluid, vol = (torch.stack(x) for x in zip(*outs))
        return MeltFrames(h=h, eta=eta, tracer_pos=pos, tracer_norm=nrm,
                          tracer_fluid=fluid, volume=vol)

    def frame_mesh(self, frames: MeltFrames,
                   f: int) -> tuple[np.ndarray, np.ndarray]:
        """Triangulate frame f's fluid surface on the host (for shadow
        hulls and replay): (vertices (V, 3) float32, faces (T, 3) int64)."""
        cfg = self.cfg
        r = cfg.resolution
        h = frames.h[f].cpu().numpy()
        eta = frames.eta[f].cpu().numpy()
        wet = h > cfg.min_depth
        xs = self.origin[0] + (np.arange(r) + 0.5) * self.cell
        ys = self.origin[1] + (np.arange(r) + 0.5) * self.cell
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        verts = np.stack([gx, gy, self.ground_z + eta], -1).reshape(-1, 3)
        # quads whose 4 corners are wet
        quad = wet[:-1, :-1] & wet[1:, :-1] & wet[:-1, 1:] & wet[1:, 1:]
        qi, qj = np.nonzero(quad)
        if len(qi) == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        v00 = qi * r + qj
        v10 = (qi + 1) * r + qj
        v01 = qi * r + (qj + 1)
        v11 = (qi + 1) * r + (qj + 1)
        faces = np.concatenate([np.stack([v00, v10, v11], -1),
                                np.stack([v00, v11, v01], -1)], axis=0)
        used = np.unique(faces)
        remap = np.full(verts.shape[0], -1, np.int64)
        remap[used] = np.arange(len(used))
        return verts[used].astype(np.float32), remap[faces].astype(np.int64)


def bed_from_mesh(
    scene_vertices: np.ndarray,
    scene_faces: np.ndarray,
    origin: np.ndarray,
    extent: float,
    resolution: int,
    ground_z: float = 0.0,
    z_top: float = 1e3,
    device=devices.DEFAULT,
) -> np.ndarray:
    """(R, R) top-down height map of the scene mesh over the melt domain,
    RELATIVE to ``ground_z`` (the solver's datum), by casting one ray
    down per cell (``ops.raymesh.ray_mesh_first_hit`` on ``device``)."""
    from autovfx_tpu_torch.ops.raymesh import ray_mesh_first_hit

    device = devices.resolve(device)
    r = resolution
    cell = extent / r
    xs = origin[0] + (np.arange(r) + 0.5) * cell
    ys = origin[1] + (np.arange(r) + 0.5) * cell
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    origins = np.stack([gx.ravel(), gy.ravel(),
                        np.full(r * r, z_top, np.float32)], -1
                       ).astype(np.float32)
    dirs = np.tile(np.array([0, 0, -1.0], np.float32), (r * r, 1))
    v = np.asarray(scene_vertices, np.float32)
    fidx = np.asarray(scene_faces)
    t = lambda a: torch.tensor(a, device=device)
    dist, _, hit = ray_mesh_first_hit(t(origins), t(dirs), t(v[fidx[:, 0]]),
                                      t(v[fidx[:, 1]]), t(v[fidx[:, 2]]))
    z_hit = z_top - dist.cpu().numpy()
    z_hit = np.where(hit.cpu().numpy(), z_hit, ground_z)
    return (z_hit - ground_z).reshape(r, r).astype(np.float32)


def apply_melt_to_gaussians(g, idx, frames: MeltFrames, f: int,
                            cell: float):
    """An extracted object's splats moved to the liquid state of frame
    ``f``: rows ``idx`` of ``g`` (the MeltSim was built on
    ``g.xyz[idx]``, in that order) take their tracers' positions; melted
    ones flatten into the film (z scale at most 0.4 cells) and lie in
    its plane (identity rotation), unmelted ones ride the solid."""
    import dataclasses

    idx = torch.as_tensor(idx if torch.is_tensor(idx) else np.asarray(idx),
                          dtype=torch.int64, device=g.xyz.device)
    fluid = (frames.tracer_fluid[f] > 0.5)[:, None]
    xyz = g.xyz.clone()
    xyz[idx] = frames.tracer_pos[f]
    sc = take(g.log_scales, idx)
    film_z = float(torch.log(torch.tensor(max(cell * 0.4, 1e-5))))
    sc_melt = torch.stack([sc[:, 0], sc[:, 1],
                           torch.clamp(sc[:, 2], max=film_z)], dim=-1)
    log_scales = g.log_scales.clone()
    log_scales[idx] = torch.where(fluid, sc_melt, sc)
    q = take(g.quats, idx)
    quat_id = torch.zeros_like(q)
    quat_id[:, 0] = 1.0
    quats = g.quats.clone()
    quats[idx] = torch.where(fluid, quat_id, q)
    return dataclasses.replace(g, xyz=xyz, log_scales=log_scales,
                               quats=quats)
