"""Plain PyTorch effects frame: the edited frame of a burning, melting
object, with the clip's smoke and melt solved here from the
configuration and the seed.

A frozen copy of the program's plain paths (``render/smoke``'s solver
step, adaptive recentring, lattice-hash value noise, densest-cell sort
and smoke and fire splats; ``render/liquid``'s thin-film substeps and
tracers; ``render/clip``'s fused frame with the fire pass) with no
import of the program.  The merged render, the shading, the hull object
weight and the shadow are ``reference.edit``'s and ``reference.raster``'s.
Float32 throughout, TF32 off; the noise's lattice hash computes on the
32 bits of int32 values held in int64, as the program does, so it is
bit-equal to it on every device.

Inputs the benchmark makes from the seed and hands to both sides:
``rest_pose`` (the cube at rest), ``placement`` (the smoke domain and
its jittered inflow), ``melt_inputs`` (the cube's surfels posed at rest
and the melt's progress).  ``solve`` works the clip out from them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark import scene
from benchmark.reference import edit, raster
from benchmark.reference.train import ieee_float32

FIRE_SCALE = 2.0  # fire color = blackbody(t) * (1 + 2 t)
SPLAT_SCALE = 0.9  # a smoke splat's scale, in cells
SPLAT_OPACITY = 0.8  # opacity = min(0.8 density, 0.95)
MAX_OPACITY = 0.95
# the splat set's defaults: 40,000 slots at 48^3, growing with the square
# of the resolution up to 160,000; gray smoke; fire above temperature 0.4
SPLATS_AT_48, MAX_SPLATS = 40_000, 160_000
DENSITY_THRESHOLD = 0.02
SMOKE_COLOR = 0.35
FIRE_THRESHOLD = 0.4
NOISE_DRIFT = 0.35  # the noise lattice scrolls up this many cells a frame
NOISE_SEED = 17  # the first octave's hash seed; octave o uses 17 + o
_U32 = 0xFFFFFFFF
_COLD = np.array([0.6, 0.05, 0.0], np.float32)
_MID = np.array([1.0, 0.45, 0.05], np.float32)
_HOT = np.array([1.0, 0.95, 0.7], np.float32)


# ---- the inputs ----------------------------------------------------------------


def rest_pose(edit_cfg: dict, frames: int, seed: int):
    """(F, 1, 3) positions and (F, 1, 3, 3) rotations of the cube at rest
    for the whole clip: the seeded spot and first yaw of
    ``scene.cube_drop``, on the ground."""
    pos, rot = scene.cube_drop(edit_cfg, 1, seed)
    pos[..., 2] = edit_cfg["ground_z"] + edit_cfg["cube_half"]
    return np.repeat(pos, frames, 0), np.repeat(rot, frames, 0)


class Placement(NamedTuple):
    origin: np.ndarray  # (3,) float32, the domain's corner at frame 0
    extent: float  # m
    inflow_cell: tuple  # the inflow sphere's centre, in cells
    inflow_radius: float  # cells


def placement(fx: dict, pos: np.ndarray, seed: int) -> Placement:
    """The smoke domain over the one emitter at the cube's centre, placed
    as the edit program places it (extent max(scale (spread + 1), min),
    origin = centre - extent * fraction), and the inflow's centre
    jittered by the seed by at most ``inflow_jitter`` cells an axis."""
    dom, r = fx["domain"], fx["smoke"]["resolution"]
    centre = pos[0, 0].astype(np.float64)
    extent = max(dom["extent_scale"] * (0.0 + 1.0), dom["extent_min"])
    origin = centre - extent * np.asarray(dom["origin_fraction"])
    rng = np.random.default_rng((int(seed) + 3) % (1 << 63))
    jitter = rng.uniform(-dom["inflow_jitter"], dom["inflow_jitter"], 3)
    cell = (centre - origin) / extent * r + jitter
    return Placement(origin.astype(np.float32), float(extent),
                     tuple(float(c) for c in cell),
                     dom["inflow_radius"] * r)


class MeltInputs(NamedTuple):
    points: np.ndarray  # (S, 3) float32, world, posed at rest
    normals: np.ndarray  # (S, 3)
    progress: np.ndarray  # (F,) float32, linear 0 -> 1


def melt_inputs(surf: dict, pos: np.ndarray, rot: np.ndarray,
                frames: int) -> MeltInputs:
    r, p = rot[0, 0], pos[0, 0]
    pts = surf["points"].detach().cpu().numpy().astype(np.float32)
    nrm = surf["normals"].detach().cpu().numpy().astype(np.float32)
    prog = np.clip(np.arange(frames, dtype=np.float32) / max(frames - 1, 1),
                   0.0, 1.0)
    return MeltInputs((pts @ r.T + p).astype(np.float32),
                      (nrm @ r.T).astype(np.float32), prog)


# ---- the smoke solve -------------------------------------------------------------


def grid_coords(r: int, device) -> torch.Tensor:
    ii = torch.arange(r, device=device)
    return torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"),
                       -1).to(torch.float32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                      *x.shape[1:])


def _corners(pos: torch.Tensor, r: int):
    p = torch.clamp(pos, 0.0, r - 1.001)
    i0 = torch.floor(p)
    f = p - i0
    i0 = i0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=r - 1)
    x, y, z = ((i0[..., a], i1[..., a]) for a in range(3))
    flat = [(x[a] * r + y[b]) * r + z[c]
            for c in (0, 1) for b in (0, 1) for a in (0, 1)]
    return flat, f


def _interp(field: torch.Tensor, flat, f: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup of an (R, R, R[, C]) field, x fastest."""
    r = field.shape[0]
    table = field.reshape(r * r * r, *field.shape[3:])
    c000, c100, c010, c110, c001, c101, c011, c111 = (_take(table, i)
                                                      for i in flat)
    if field.dim() == 4:
        fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    else:
        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _grad(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.gradient(x, dim=axis)[0]


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])
    return n[..., None] if keepdim else n


def smoke_step(density, temp, vel, inflow, s: dict):
    """One stable-fluids step: semi-Lagrangian advection, dissipation,
    the linear dissolve, inflow, buoyancy along +z, vorticity
    confinement, a Jacobi pressure projection and closed faces."""
    r = s["resolution"]
    coords = grid_coords(r, density.device)
    back = coords - s["dt"] * vel * r
    flat, f = _corners(back, r)
    d = _interp(density, flat, f) * s["dissipation"]
    t = _interp(temp, flat, f) * s["temperature_diff"]
    v = _interp(vel, flat, f)
    if s["dissolve_speed"] > 0:
        d = torch.clamp(d - s["inflow_density"] / s["dissolve_speed"],
                        min=0.0)
    d = torch.maximum(d, inflow * s["inflow_density"])
    t = torch.maximum(t, inflow * s["inflow_temperature"])
    v = torch.cat([v[..., :2],
                   v[..., 2:] + (s["dt"] * s["buoyancy"] * t)[..., None]],
                  dim=-1)
    if s["vorticity"] > 0.0:
        v0, v1, v2 = v.unbind(-1)
        w = torch.stack([_grad(v2, 1) - _grad(v1, 2),
                         _grad(v0, 2) - _grad(v2, 0),
                         _grad(v1, 0) - _grad(v0, 1)], dim=-1)
        wmag = _norm(w)
        eta = torch.stack([_grad(wmag, a) for a in range(3)], dim=-1)
        n_eta = eta / torch.clamp(_norm(eta, keepdim=True), min=1e-6)
        v = v + s["dt"] * s["vorticity"] * torch.linalg.cross(n_eta, w,
                                                              dim=-1)
    div = _grad(v[..., 0], 0) + _grad(v[..., 1], 1) + _grad(v[..., 2], 2)
    p = torch.zeros_like(div)
    for _ in range(s["jacobi_iters"]):
        p = (torch.roll(p, 1, 0) + torch.roll(p, -1, 0)
             + torch.roll(p, 1, 1) + torch.roll(p, -1, 1)
             + torch.roll(p, 1, 2) + torch.roll(p, -1, 2) - div) / 6.0
    v = v - torch.stack([_grad(p, a) for a in range(3)], dim=-1)
    v[0, :, :, 0] = 0.0
    v[-1, :, :, 0] = 0.0
    v[:, 0, :, 1] = 0.0
    v[:, -1, :, 1] = 0.0
    v[:, :, 0, 2] = 0.0
    v[:, :, -1, 2] = 0.0
    return d, t, v


def _shift(field: torch.Tensor, s: torch.Tensor, axis: int) -> torch.Tensor:
    """out[i] = field[i + s] along ``axis`` where inside, else 0."""
    r = field.shape[axis]
    src = torch.arange(r, device=field.device) + s
    keep = (src >= 0) & (src < r)
    moved = field.index_select(axis, torch.clamp(src, 0, r - 1))
    shape = [1] * field.dim()
    shape[axis] = r
    return torch.where(keep.reshape(shape), moved, torch.zeros_like(moved))


def inflow_mask(r: int, centre, radius: float, device) -> torch.Tensor:
    c = torch.tensor([float(x) for x in centre], device=device)
    return (_norm(grid_coords(r, device) - c) < radius).to(torch.float32)


def solve_smoke(s: dict, inflow: torch.Tensor, frames: int,
                max_shift: int):
    """The adaptive clip: (density (F, R, R, R), temperature, origin cells
    (F, 3) int32).  Each frame the world-fixed emitter is moved into the
    domain's frame, a step runs, and the domain recentres toward the
    density centroid by at most ``max_shift`` cells an axis."""
    r = s["resolution"]
    dev = inflow.device
    z = lambda *c: torch.zeros((r, r, r) + c, device=dev)
    d, t, v = z(), z(), z(3)
    on = torch.ones(frames, device=dev)
    coords = grid_coords(r, dev)
    centre = (r - 1) / 2.0
    origin = torch.zeros(3, dtype=torch.int32, device=dev)
    dens, temps, origins = [], [], []
    for f in range(frames):
        m = inflow
        for ax in range(3):
            m = _shift(m, origin[ax], ax)
        d, t, v = smoke_step(d, t, v, m * on[f], s)
        mass = torch.clamp(torch.sum(d), min=1e-6)
        com = torch.sum(d[..., None] * coords, dim=(0, 1, 2)) / mass
        shift = torch.clamp(torch.round(com - centre).to(torch.int32),
                            -max_shift, max_shift)
        shift = torch.where(mass > 1e-3, shift, torch.zeros_like(shift))
        for ax in range(3):
            d = _shift(d, shift[ax], ax)
            t = _shift(t, shift[ax], ax)
            v = _shift(v, shift[ax], ax)
        origin = origin + shift
        dens.append(d)
        temps.append(t)
        origins.append(origin)
    return torch.stack(dens), torch.stack(temps), torch.stack(origins)


# ---- the display noise -----------------------------------------------------------


def _divide(x: torch.Tensor, s: float) -> torch.Tensor:
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _ashr32(u: torch.Tensor, k: int) -> torch.Tensor:
    """int32 ``h >> k`` (arithmetic) on the bits ``u`` of ``h``."""
    return (u >> k) | (u >> 31) * (_U32 ^ (_U32 >> k))


def lattice_hash(ix, iy, iz, seed: int) -> torch.Tensor:
    ix, iy, iz = (x.to(torch.int64) for x in (ix, iy, iz))
    u = (ix * 374761393 + iy * 668265263 + iz * 1442695041
         + int(seed) * 974711) & _U32
    u = ((u ^ _ashr32(u, 13)) * 1274126177) & _U32
    u = u ^ _ashr32(u, 16)
    return _divide((u & 0xFFFF).to(torch.float32), 65535.0)


def value_noise3(coords: torch.Tensor, period: float,
                 seed: int) -> torch.Tensor:
    p = _divide(coords, period)
    i0 = torch.floor(p)
    f = p - i0
    f = f * f * (3.0 - 2.0 * f)
    i0 = i0.to(torch.int64)
    ix, iy, iz = i0.unbind(-1)
    at = lambda dx, dy, dz: lattice_hash(ix + dx, iy + dy, iz + dz, seed)
    fx, fy, fz = f.unbind(-1)
    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def density_noise(density: torch.Tensor, frame: int, s: dict) -> torch.Tensor:
    """The display noise's octaves on frame ``frame``'s density."""
    if s["noise_octaves"] <= 0 or s["noise_strength"] <= 0.0:
        return density
    r = density.shape[0]
    coords = grid_coords(r, density.device)
    drift = float(torch.tensor(float(frame)) * NOISE_DRIFT)
    coords = torch.cat([coords[..., :2], coords[..., 2:] - drift], dim=-1)
    n = torch.zeros_like(density)
    amp_sum, amp, period = 0.0, 1.0, s["noise_scale"] * r
    for o in range(s["noise_octaves"]):
        n = n + amp * value_noise3(coords, period, seed=NOISE_SEED + o)
        amp_sum += amp
        amp *= 0.5
        period *= 0.5
    n = _divide(n, amp_sum)
    mod = 1.0 + s["noise_strength"] * (2.0 * n - 1.0)
    return density * torch.clamp(mod, min=0.0)


# ---- the smoke and fire splats ---------------------------------------------------


def blackbody(t: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(t, 0.0, 1.0)
    low, high = 2 * t, 2 * t - 1
    return torch.stack([
        torch.where(t < 0.5, float(c) + float(m - c) * low,
                    float(m) + float(h - m) * high)
        for c, m, h in zip(_COLD, _MID, _HOT)], dim=-1)


def _logit(alpha: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(alpha, min=1e-5)
                     / torch.clamp(1 - alpha, min=1e-5))


def splats(density, temp, origin, extent):
    """(smoke, fire) splat sets of one frame's fields: the
    ``max_splats`` densest cells above the threshold, sorted stably
    (lower index first among ties); smoke gray, fire where the cell is
    hotter than the threshold, blackbody-colored."""
    r = density.shape[0]
    dev = density.device
    cell = extent / r
    dens = density.reshape(-1)
    score = torch.where(dens > DENSITY_THRESHOLD, dens,
                        torch.zeros_like(dens))
    k = min(int(SPLATS_AT_48 * (r / 48.0) ** 2), MAX_SPLATS, dens.numel())
    top, idx = torch.sort(score, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    pos = origin[None] + (_take(grid_coords(r, dev).reshape(-1, 3), idx)
                          + 0.5) * cell
    d = _take(dens, idx)
    t = _take(temp.reshape(-1), idx)
    log_s = torch.log(torch.as_tensor(cell * SPLAT_SCALE, dtype=torch.float32,
                                      device=dev))
    quats = torch.zeros((k, 4), device=dev)
    quats[:, 0] = 1.0
    base = {"xyz": pos, "sh_rest": torch.zeros((k, 15, 3), device=dev),
            "log_scales": log_s.reshape(1, 1).expand(k, 3).contiguous(),
            "quats": quats}
    active = top > 0
    fire = t > FIRE_THRESHOLD
    alpha = torch.clamp(d * SPLAT_OPACITY, 0.0, MAX_OPACITY)
    gray = torch.full((k, 3), SMOKE_COLOR, device=dev)
    smoke = dict(base, sh_dc=(gray - 0.5) / raster.SH_C0,
                 opacity_logit=_logit(alpha), active=active)
    rgb = blackbody(t) * (1.0 + FIRE_SCALE * t[:, None])
    flame = dict(base, sh_dc=(rgb - 0.5) / raster.SH_C0,
                 opacity_logit=_logit(alpha * fire.to(torch.float32)),
                 active=active & fire)
    return smoke, flame


# ---- the melt --------------------------------------------------------------------


def _bilinear(field: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    r = field.shape[0]
    p = torch.clamp(xy, 0.0, r - 1.001)
    i0 = torch.floor(p)
    f = p - i0
    i0 = i0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=r - 1)
    flat = field.reshape(-1)
    at = lambda ix, iy: _take(flat, ix * r + iy)
    c0 = (at(i0[:, 0], i0[:, 1]) * (1 - f[:, 0])
          + at(i1[:, 0], i0[:, 1]) * f[:, 0])
    c1 = (at(i0[:, 0], i1[:, 1]) * (1 - f[:, 0])
          + at(i1[:, 0], i1[:, 1]) * f[:, 0])
    return c0 * (1 - f[:, 1]) + c1 * f[:, 1]


def film_substep(h, bed, source, cell: float, m: dict):
    """One explicit thin-film update: donor-cell face diffusivities
    h³/3ν clamped at the stability limit, fluxes limited to the donor's
    depth, the divergence by slice additions; (h, velocity (R, R, 2))."""
    dt = m["dt"] / m["substeps"]
    inv_c = 1.0 / cell
    h = h + source
    eta = bed + h

    def face_flux(axis):
        if axis == 0:
            deta = (eta[1:, :] - eta[:-1, :]) * inv_c
            h_lo, h_hi = h[:-1, :], h[1:, :]
        else:
            deta = (eta[:, 1:] - eta[:, :-1]) * inv_c
            h_lo, h_hi = h[:, :-1], h[:, 1:]
        h_up = torch.where(deta > 0, h_hi, h_lo)
        d_stab = 0.9 * cell * cell / (4.0 * dt)
        d = torch.clamp(h_up * h_up * h_up / (3.0 * m["viscosity"]),
                        max=d_stab)
        cap = h_up * cell / (4.0 * dt)
        return torch.clamp(d * deta, -cap, cap)

    fx, fy = face_flux(0), face_flux(1)
    div = torch.zeros_like(h)
    div[:-1, :] += fx
    div[1:, :] -= fx
    div[:, :-1] += fy
    div[:, 1:] -= fy
    h_new = torch.clamp(h + dt * inv_c * div, min=0.0)
    ux = torch.zeros_like(h)
    ux[:-1, :] += 0.5 * fx
    ux[1:, :] += 0.5 * fx
    uy = torch.zeros_like(h)
    uy[:, :-1] += 0.5 * fy
    uy[:, 1:] += 0.5 * fy
    hd = torch.clamp(h_new, min=m["min_depth"])
    return h_new, torch.stack([-ux / hd, -uy / hd], dim=-1)


def solve_melt(mi: MeltInputs, ground_z: float, m: dict, device):
    """The melt over the clip: tracer positions and normals (F, S, 3).
    The film is fed through the object's footprint as the progress
    rises (volume 0.6 · footprint · height); melted tracers (above the
    solid's falling top) ride the film at the advected xy, the others
    keep their rest pose."""
    r = m["resolution"]
    pts = np.asarray(mi.points, np.float32)
    centre = pts[:, :2].mean(0)
    radius = max(float(np.max(np.linalg.norm(pts[:, :2] - centre[None],
                                             axis=1))), 1e-3)
    extent = 2.0 * m["margin"] * radius
    origin_np = centre - 0.5 * extent
    cell = extent / r
    height = float(max((pts[:, 2] - ground_z).max(), 1e-4))
    gx = np.clip((pts[:, 0] - origin_np[0]) / cell, 0, r - 1).astype(np.int32)
    gy = np.clip((pts[:, 1] - origin_np[1]) / cell, 0, r - 1).astype(np.int32)
    occ = np.zeros((r, r), np.float32)
    np.add.at(occ, (gx, gy), 1.0)
    volume = 0.6 * float(max(np.sum(occ > 0), 1.0)) * cell**2 * height
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    footprint, bed = t(occ > 0), t(np.zeros((r, r), np.float32))
    pts0, nrm0 = t(pts), t(mi.normals)

    prog = torch.as_tensor(np.asarray(mi.progress, np.float32), device=device)
    dprog = prog - torch.cat([torch.zeros(1, device=device), prog[:-1]])
    foot_w = footprint / torch.clamp(torch.sum(footprint), min=1.0)
    origin = torch.as_tensor(np.asarray(origin_np, np.float32), device=device)
    h_rel = (pts0[:, 2] - ground_z) / height
    inv_c = 1.0 / cell
    h = torch.zeros((r, r), device=device)
    txy = torch.clamp((pts0[:, :2] - origin[None]) / cell, 0.0, r - 1.001)
    out_pos, out_nrm = [], []
    for f in range(prog.shape[0]):
        p_f, dp = prog[f], dprog[f]
        src = (dp * volume / cell**2 / m["substeps"]) * foot_w
        for _ in range(m["substeps"]):
            h, u = film_substep(h, bed, src, cell, m)
            uxy = torch.stack([_bilinear(u[..., 0], txy),
                               _bilinear(u[..., 1], txy)], -1)
            txy = txy + uxy * (m["dt"] / m["substeps"]) / cell
            txy = torch.clamp(txy, 0.0, r - 1.001)
        eta = bed + h
        melted = (h_rel > (1.0 - p_f) + 1e-6) | (p_f >= 1.0)
        h_at = _bilinear(h, txy)
        eta_at = _bilinear(eta, txy)
        z_fluid = torch.where(h_at > m["min_depth"],
                              ground_z + eta_at - 0.25 * h_at,
                              torch.full_like(h_at, ground_z))
        xy_fluid = origin[None] + (txy + 0.5) * cell
        out_pos.append(torch.cat([
            torch.where(melted[:, None], xy_fluid, pts0[:, :2]),
            torch.where(melted, z_fluid, pts0[:, 2])[:, None]], dim=-1))
        gxe = torch.gradient(eta, dim=0)[0] * inv_c
        gye = torch.gradient(eta, dim=1)[0] * inv_c
        nx, ny = -_bilinear(gxe, txy), -_bilinear(gye, txy)
        n_fluid = torch.stack([nx, ny, torch.ones_like(nx)], -1)
        n_fluid = n_fluid / torch.sqrt(nx * nx + ny * ny + 1.0)[:, None]
        out_nrm.append(torch.where(melted[:, None], n_fluid, nrm0))
    return torch.stack(out_pos), torch.stack(out_nrm)


# ---- the clip and its frames -----------------------------------------------------


class Effects(NamedTuple):
    """The clip's solved effects, on the device."""

    density: torch.Tensor  # (F, R, R, R)
    temperature: torch.Tensor  # (F, R, R, R)
    origin_cells: torch.Tensor  # (F, 3) int32
    origin: torch.Tensor  # (3,)
    extent: torch.Tensor  # ()
    melt_pos: torch.Tensor  # (F, S, 3)
    melt_norm: torch.Tensor  # (F, S, 3)
    smoke: dict  # the configuration's smoke parameters


def solve(fx: dict, place: Placement, mi: MeltInputs, ground_z: float,
          frames: int, device) -> Effects:
    """The clip's smoke and melt from the configuration's ``effects``
    block and the seeded inputs."""
    s = fx["smoke"]
    with ieee_float32(), torch.no_grad():
        mask = inflow_mask(s["resolution"], place.inflow_cell,
                           place.inflow_radius, device)
        dom = fx["domain"]  # a fixed domain never shifts
        dens, temp, cells = solve_smoke(
            s, mask, frames, dom["max_shift"] if dom["adaptive"] else 0)
        pos, nrm = solve_melt(mi, ground_z, fx["melt"], device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Effects(dens, temp, cells, f32(place.origin), f32(place.extent),
                   pos, nrm, s)


def frame_splats(fx: Effects, i: int):
    """Frame ``i``'s (smoke, fire) sets: the density with its display
    noise, at the domain's origin moved by the adaptive offset."""
    cell = fx.extent / fx.density.shape[1]
    origin = fx.origin + fx.origin_cells[i].to(torch.float32) * cell
    return splats(density_noise(fx.density[i], i, fx.smoke),
                  fx.temperature[i], origin, fx.extent)


def melted_object(clip: edit.Clip, fx: Effects, i: int,
                  cam: raster.Cam) -> dict:
    """The cube's surfels at their frame-``i`` tracer poses, shaded for
    ``cam`` (``edit.object_gaussians`` on the tracers, whose world poses
    stand in for the body frame under an identity pose)."""
    dev = fx.melt_pos.device
    tracers = clip._replace(
        points=fx.melt_pos[i], normals=fx.melt_norm[i],
        rot=torch.eye(3, device=dev).reshape(1, 1, 3, 3),
        pos=torch.zeros((1, 1, 3), device=dev))
    return edit.object_gaussians(tracers, 0, cam)


def need(bg: dict, clip: edit.Clip, fx: Effects, i: int,
         cam: raster.Cam, tile: int) -> tuple[int, int]:
    """The duplicates frame ``i``'s merged render and fire render ask
    for."""
    with ieee_float32(), torch.no_grad():
        smoke, fire = frame_splats(fx, i)
        obj = melted_object(clip, fx, i, cam)
        return (raster.need([bg, obj, smoke], cam, tile),
                raster.need([fire], cam, tile))


def frame(bg: dict, clip: edit.Clip, fx: Effects, i: int, cam: raster.Cam,
          tile: int, shadow_scale: int, lowp: bool = False,
          counts: bool = False):
    """Effects frame ``i``: the merged render of the background, the
    melted cube and the smoke; the hull object weight and shadow; the
    fire render alone, added: (H, W, 3) in [0, 1], and with ``counts``
    the (merged, fire) renders' ``raster.Counts``."""
    with ieee_float32(), torch.no_grad():
        smoke, fire = frame_splats(fx, i)
        obj = melted_object(clip, fx, i, cam)
        out = raster.render([bg, obj, smoke], cam, tile, lowp=lowp,
                            counts=counts)
        img, c = out if counts else (out, None)
        alpha = torch.clamp(img.alpha, 0.0, 1.0)
        scene_depth = torch.where(
            alpha > edit.DEPTH_ALPHA, img.depth / torch.clamp(alpha, min=1e-6),
            torch.full_like(alpha, edit.NO_DEPTH))
        planes = edit.world_planes(clip, i)
        w_obj = edit.object_weight(cam, scene_depth, planes, clip.mask,
                                   3.0 * clip.radius)
        ratio = torch.clamp(edit.shadow_ratio(
            cam, img.depth, torch.clamp(alpha, min=1e-3), clip.light_dirs,
            clip.light_weights, planes, clip.mask, shadow_scale), 0.0, 1.0)
        mult = 1.0 - (1.0 - ratio) * (1.0 - w_obj) * alpha
        mult = torch.where(torch.abs(ratio - 1.0) >= 0.01, mult,
                           torch.ones_like(mult))
        flame = raster.render([fire], cam, tile, lowp=lowp, counts=counts)
        f_img, f_c = flame if counts else (flame, None)
        out_img = torch.clamp(img.color * mult[..., None] + f_img.color,
                              0.0, 1.0)
    return (out_img, c, f_c) if counts else out_img
