"""Smoke and fire: a grid fluid on the device, rendered as Gaussian volumes.

Counterpart of ``autovfx_tpu/render/smoke.py``: a semi-Lagrangian smoke
solver (advect density, temperature and velocity; dissolve, inflow,
buoyancy, vorticity confinement; a Jacobi pressure projection) on a
fixed R³ grid, whose frames become splats: smoke as gray absorbing
splats in the merged render, fire as emissive blackbody-colored splats
rendered alone and added to the frame (``render.clip``).

Everything runs as tensor operations on the fields' device with no read
back to the host: the adaptive domain's recentering shift stays a device
integer and moves the fields by index arithmetic (``_shift_zero_fill``),
so a step waits on nothing.  Choices that keep the JAX package's
results:

- the trilinear samples gather from the flattened fields with one
  ``index_select`` per corner (``utils.gather.take``);
- the densest cells are taken by a stable descending sort, so among
  equal scores the lower cell index comes first, as ``jax.lax.top_k``
  orders them (``torch.topk`` does not);
- the lattice hash of the display noise computes on the 32 bits of the
  JAX package's int32 values held in int64, with explicit wraps and
  arithmetic shifts, so it relies neither on signed overflow nor on how
  a build shifts negative integers; the noise divides by device scalars
  (``_divide``), so the card's result is the CPU's bit for bit.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.core.sh import rgb_to_sh
from autovfx_tpu_torch.utils.gather import take


class SmokeConfig(NamedTuple):
    resolution: int = 48  # cells per axis
    buoyancy: float = 4.0
    dissipation: float = 0.985
    temperature_diff: float = 0.92
    inflow_density: float = 0.9
    inflow_temperature: float = 1.0
    vorticity: float = 2.0  # confinement strength; 0 = off
    jacobi_iters: int = 20
    dt: float = 1.0 / 15.0
    with_fire: bool = False
    # display-time value-noise octaves that modulate the rendered density
    noise_octaves: int = 2
    noise_strength: float = 0.7
    noise_scale: float = 0.22  # lattice period as a fraction of R
    # density fades out over this many frames; 0 = off
    dissolve_speed: int = 0


class SmokeState(NamedTuple):
    density: torch.Tensor  # (R, R, R)
    temperature: torch.Tensor  # (R, R, R)
    velocity: torch.Tensor  # (R, R, R, 3)


def init_state(cfg: SmokeConfig, device=devices.DEFAULT) -> SmokeState:
    device = devices.resolve(device)
    r = cfg.resolution
    z = lambda *s: torch.zeros((r, r, r) + s, device=device)
    return SmokeState(density=z(), temperature=z(), velocity=z(3))


@functools.lru_cache(maxsize=8)
def _grid_coords(r: int, device: torch.device) -> torch.Tensor:
    """(R, R, R, 3) float32 cell indices (read only: it is shared)."""
    ii = torch.arange(r, device=device)
    return torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"),
                       -1).to(torch.float32)


def _corners(pos: torch.Tensor, r: int):
    """The 8 flat cell indices (x-fastest corner order of ``_sample``)
    and the fractions of a trilinear lookup at grid coords ``pos``."""
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
    r = field.shape[0]
    table = field.reshape(r * r * r, *field.shape[3:])
    c000, c100, c010, c110, c001, c101, c011, c111 = (take(table, i)
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


def _sample(field: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of an (R, R, R[, C]) field at grid coords
    (R, R, R, 3)."""
    flat, f = _corners(pos, field.shape[0])
    return _interp(field, flat, f)


def _grad(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Central differences inside, one-sided at the faces (numpy's
    ``gradient`` with unit spacing)."""
    return torch.gradient(x, dim=axis)[0]


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])
    return n[..., None] if keepdim else n


def step(state: SmokeState, inflow_mask: torch.Tensor,
         cfg: SmokeConfig) -> SmokeState:
    """One solver step: advect, dissolve, inflow, buoyancy, vorticity
    confinement, projection, closed faces."""
    r = cfg.resolution
    coords = _grid_coords(r, state.density.device)

    # semi-Lagrangian advection
    back = coords - cfg.dt * state.velocity * r
    flat, f = _corners(back, r)
    density = _interp(state.density, flat, f) * cfg.dissipation
    temp = _interp(state.temperature, flat, f) * cfg.temperature_diff
    vel = _interp(state.velocity, flat, f)

    if cfg.dissolve_speed > 0:  # linear fade over dissolve_speed frames
        density = torch.clamp(
            density - cfg.inflow_density / cfg.dissolve_speed, min=0.0)

    density = torch.maximum(density, inflow_mask * cfg.inflow_density)
    temp = torch.maximum(temp, inflow_mask * cfg.inflow_temperature)

    # buoyancy along +z
    vel = torch.cat([vel[..., :2],
                     vel[..., 2:] + (cfg.dt * cfg.buoyancy * temp)[..., None]],
                    dim=-1)

    if cfg.vorticity > 0.0:  # vorticity confinement (Fedkiw et al.)
        v0, v1, v2 = vel.unbind(-1)
        w = torch.stack([_grad(v2, 1) - _grad(v1, 2),
                         _grad(v0, 2) - _grad(v2, 0),
                         _grad(v1, 0) - _grad(v0, 1)], dim=-1)
        wmag = _norm(w)
        eta = torch.stack([_grad(wmag, a) for a in range(3)], dim=-1)
        n_eta = eta / torch.clamp(_norm(eta, keepdim=True), min=1e-6)
        vel = vel + cfg.dt * cfg.vorticity * torch.linalg.cross(n_eta, w,
                                                                 dim=-1)

    # incompressibility: Jacobi pressure solve on the divergence
    d = _grad(vel[..., 0], 0) + _grad(vel[..., 1], 1) + _grad(vel[..., 2], 2)
    p = torch.zeros_like(d)
    for _ in range(cfg.jacobi_iters):
        p = (torch.roll(p, 1, 0) + torch.roll(p, -1, 0)
             + torch.roll(p, 1, 1) + torch.roll(p, -1, 1)
             + torch.roll(p, 1, 2) + torch.roll(p, -1, 2) - d) / 6.0
    vel = vel - torch.stack([_grad(p, a) for a in range(3)], dim=-1)
    # closed boundaries: zero normal velocity at the domain faces
    vel[0, :, :, 0] = 0.0
    vel[-1, :, :, 0] = 0.0
    vel[:, 0, :, 1] = 0.0
    vel[:, -1, :, 1] = 0.0
    vel[:, :, 0, 2] = 0.0
    vel[:, :, -1, 2] = 0.0
    return SmokeState(density=density, temperature=temp, velocity=vel)


def _shift_zero_fill(field: torch.Tensor, s: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """``field`` moved by -s cells along ``axis`` with zero fill (no
    wrap): out[i] = field[i + s] where 0 <= i + s < R.  ``s`` is a
    device integer; nothing is read back."""
    r = field.shape[axis]
    src = torch.arange(r, device=field.device) + s
    keep = (src >= 0) & (src < r)
    moved = field.index_select(axis, torch.clamp(src, 0, r - 1))
    shape = [1] * field.dim()
    shape[axis] = r
    return torch.where(keep.reshape(shape), moved, torch.zeros_like(moved))


def _stack_states(states) -> SmokeState:
    return SmokeState(*(torch.stack(x) for x in zip(*states)))


def simulate_smoke(
    cfg: SmokeConfig,
    inflow_mask: torch.Tensor,
    num_frames: int,
    inflow_frames: Optional[torch.Tensor] = None,
    adaptive: bool = False,
    max_shift: int = 2,
):
    """Simulate the clip on ``inflow_mask``'s device: the stacked
    per-frame states (F, R, R, R...).

    ``inflow_frames``: optional (F,) bool, the fuel on or off per frame.
    ``adaptive=True`` recenters the fixed-resolution domain each frame
    toward the density centroid (at most ``max_shift`` cells a frame per
    axis), with the world-fixed emitter moved the other way, and returns
    (states, origin_cells (F, 3) int32): add ``origin_cells[f] * cell``
    to the domain origin when rendering frame f."""
    dev = inflow_mask.device
    if inflow_frames is None:
        on = torch.ones(num_frames, device=dev)
    else:
        on = torch.as_tensor(inflow_frames, device=dev).to(torch.float32)
    state = init_state(cfg, dev)
    states = []
    if not adaptive:
        for f in range(num_frames):
            state = step(state, inflow_mask * on[f], cfg)
            states.append(state)
        return _stack_states(states)

    r = cfg.resolution
    center = (r - 1) / 2.0
    coords = _grid_coords(r, dev)
    origin = torch.zeros(3, dtype=torch.int32, device=dev)
    origins = []
    for f in range(num_frames):
        m = inflow_mask  # the emitter is world-fixed
        for ax in range(3):
            m = _shift_zero_fill(m, origin[ax], ax)
        state = step(state, m * on[f], cfg)
        # recenter toward the density centroid
        mass = torch.clamp(torch.sum(state.density), min=1e-6)
        com = torch.sum(state.density[..., None] * coords,
                        dim=(0, 1, 2)) / mass
        shift = torch.clamp(torch.round(com - center).to(torch.int32),
                            -max_shift, max_shift)
        shift = torch.where(mass > 1e-3, shift, torch.zeros_like(shift))
        d, t, v = state
        for ax in range(3):
            d = _shift_zero_fill(d, shift[ax], ax)
            t = _shift_zero_fill(t, shift[ax], ax)
            v = _shift_zero_fill(v, shift[ax], ax)
        state = SmokeState(density=d, temperature=t, velocity=v)
        origin = origin + shift
        states.append(state)
        origins.append(origin)
    return _stack_states(states), torch.stack(origins)


# ---- display noise -------------------------------------------------------------


_U32 = 0xFFFFFFFF


def _divide(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded once, on every device: a CUDA division by a host
    scalar multiplies by its reciprocal instead, which can differ in the
    last bit, so the divisor is put on ``x``'s device."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _ashr32(u: torch.Tensor, k: int) -> torch.Tensor:
    """The int32 arithmetic shift ``h >> k`` of the int32 ``h`` whose bits
    are ``u`` (an int64 tensor in [0, 2**32)), as those bits: a logical
    shift with the sign bit copied into the top ``k`` bits.  Only
    non-negative numbers are shifted (a right shift of a negative signed
    integer is implementation-defined in C++ before C++20)."""
    return (u >> k) | (u >> 31) * (_U32 ^ (_U32 >> k))


def _lattice_hash(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
                  seed: int) -> torch.Tensor:
    """The JAX package's int32 lattice hash -> [0, 1) floats, computed on
    the int32 values' 32 bits held in int64 (bit-equal on the CPU and the
    card, with no reliance on signed overflow)."""
    ix, iy, iz = (x.to(torch.int64) for x in (ix, iy, iz))
    u = (ix * 374761393 + iy * 668265263 + iz * 1442695041
         + int(seed) * 974711) & _U32
    u = ((u ^ _ashr32(u, 13)) * 1274126177) & _U32
    u = u ^ _ashr32(u, 16)
    return _divide((u & 0xFFFF).to(torch.float32), 65535.0)


def value_noise3(coords: torch.Tensor, period: float,
                 seed: int) -> torch.Tensor:
    """Trilinear value noise in [0, 1] at (..., 3) grid coords."""
    p = _divide(coords, period)
    i0 = torch.floor(p)
    f = p - i0
    f = f * f * (3.0 - 2.0 * f)  # smoothstep fade
    i0 = i0.to(torch.int64)
    ix, iy, iz = i0.unbind(-1)

    def at(dx, dy, dz):
        return _lattice_hash(ix + dx, iy + dy, iz + dz, seed)

    fx, fy, fz = f.unbind(-1)
    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def apply_density_noise(density: torch.Tensor, frame_idx,
                        cfg: SmokeConfig) -> torch.Tensor:
    """Display-time noise octaves on the density field: each octave
    halves the period and the amplitude, and the lattice scrolls up 0.35
    cells a frame so the detail moves with the plume.  ``frame_idx`` is
    an int or a device integer."""
    if cfg.noise_octaves <= 0 or cfg.noise_strength <= 0.0:
        return density
    r = density.shape[0]
    coords = _grid_coords(r, density.device)
    if torch.is_tensor(frame_idx):
        drift = frame_idx.to(torch.float32) * 0.35
    else:  # the float32 product, with no copy to the device
        drift = float(torch.tensor(float(frame_idx)) * 0.35)
    coords = torch.cat([coords[..., :2], coords[..., 2:] - drift], dim=-1)
    n = torch.zeros_like(density)
    amp_sum, amp, period = 0.0, 1.0, cfg.noise_scale * r
    for o in range(cfg.noise_octaves):
        n = n + amp * value_noise3(coords, period, seed=17 + o)
        amp_sum += amp
        amp *= 0.5
        period *= 0.5
    n = _divide(n, amp_sum)  # [0, 1]
    mod = 1.0 + cfg.noise_strength * (2.0 * n - 1.0)
    return density * torch.clamp(mod, min=0.0)


# ---- emitters, colors, splats --------------------------------------------------


def sphere_inflow(cfg: SmokeConfig, center_cell, radius_cells,
                  device=devices.DEFAULT) -> torch.Tensor:
    """(R, R, R) float32 mask of the cells within ``radius_cells`` of
    ``center_cell``."""
    device = devices.resolve(device)
    c = torch.tensor([float(x) for x in center_cell], device=device)
    return (_norm(_grid_coords(cfg.resolution, device) - c)
            < radius_cells).to(torch.float32)


# the blackbody ramp's colors at temperatures 0, 0.5 and 1
_COLD = np.array([0.6, 0.05, 0.0], np.float32)
_MID = np.array([1.0, 0.45, 0.05], np.float32)
_HOT = np.array([1.0, 0.95, 0.7], np.float32)


def blackbody_rgb(temperature: torch.Tensor) -> torch.Tensor:
    """A blackbody ramp, temperature 0..1 -> RGB.  The colors and their
    float32 differences enter as Python scalars, so the frame copies
    nothing to the device."""
    t = torch.clamp(temperature, 0.0, 1.0)
    low, high = 2 * t, 2 * t - 1
    return torch.stack([
        torch.where(t < 0.5, float(c) + float(m - c) * low,
                    float(m) + float(h - m) * high)
        for c, m, h in zip(_COLD, _MID, _HOT)], dim=-1)


def _densest(density: torch.Tensor, threshold: float, k: int):
    """(scores, flat cell indices) of the ``k`` densest cells above
    ``threshold`` (score 0 below it), lower index first among ties."""
    dens = density.reshape(-1)
    score = torch.where(dens > threshold, dens, torch.zeros_like(dens))
    top, idx = torch.sort(score, descending=True, stable=True)
    return top[:k], idx[:k]


def _cell_splats(density, temperature, origin, extent, k, threshold):
    """The shared fields of the splats of the ``k`` densest cells."""
    r = density.shape[0]
    dev = density.device
    cell = extent / r
    top, idx = _densest(density, threshold, k)
    coords = _grid_coords(r, dev).reshape(-1, 3)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    pos = origin[None] + (take(coords, idx) + 0.5) * cell
    d_sel = take(density.reshape(-1), idx)
    t_sel = take(temperature.reshape(-1), idx)
    n = idx.shape[0]
    log_s = torch.log(torch.as_tensor(cell * 0.9, dtype=torch.float32,
                                      device=dev))
    quats = torch.zeros((n, 4), device=dev)
    quats[:, 0] = 1.0
    base = dict(xyz=pos, sh_rest=torch.zeros((n, 15, 3), device=dev),
                log_scales=log_s.reshape(1, 1).expand(n, 3).contiguous(),
                quats=quats)
    return base, top > 0, d_sel, t_sel


def _logit(alpha: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(alpha, min=1e-5)
                     / torch.clamp(1 - alpha, min=1e-5))


def smoke_to_gaussians(
    density: torch.Tensor,
    temperature: torch.Tensor,
    origin,
    extent,
    max_splats: int = 40_000,
    density_threshold: float = 0.02,
    smoke_color: float = 0.35,
    with_fire: bool = False,
    fire_temp_threshold: float = 0.4,
) -> Gaussians:
    """One frame's fields -> one set of splats (fixed capacity, masked):
    gray smoke, and with ``with_fire`` blackbody colors where it is hot."""
    k = min(max_splats, density.numel())
    base, active, d_sel, t_sel = _cell_splats(
        density, temperature, origin, extent, k, density_threshold)
    n = active.shape[0]
    gray = torch.full((n, 3), smoke_color, device=density.device)
    if with_fire:
        rgb = torch.where((t_sel > fire_temp_threshold)[:, None],
                          blackbody_rgb(t_sel) * (1.0 + 2.0 * t_sel[:, None]),
                          gray)
    else:
        rgb = gray
    return Gaussians(sh_dc=rgb_to_sh(rgb),
                     opacity_logit=_logit(torch.clamp(d_sel * 0.8, 0.0, 0.95)),
                     active=active, **base)


def smoke_fire_gaussians(
    density: torch.Tensor,
    temperature: torch.Tensor,
    origin,
    extent,
    max_splats: Optional[int] = None,
    density_threshold: float = 0.02,
    smoke_color: float = 0.35,
    fire_temp_threshold: float = 0.4,
) -> tuple[Gaussians, Gaussians]:
    """One frame's fields -> (smoke, fire) splat sets of one static
    capacity: the smoke splats are gray absorbers for the merged render,
    the fire splats emissive blackbody colors that are rendered alone and
    added to the frame.

    ``max_splats`` defaults to 40,000 at 48³, growing with the square of
    the resolution (plume occupancy is surface-like) up to 160,000."""
    r = density.shape[0]
    if max_splats is None:
        max_splats = min(int(40_000 * (r / 48.0) ** 2), 160_000)
    k = min(max_splats, density.numel())
    base, active, d_sel, t_sel = _cell_splats(
        density, temperature, origin, extent, k, density_threshold)
    n = active.shape[0]
    fire = t_sel > fire_temp_threshold
    alpha = torch.clamp(d_sel * 0.8, 0.0, 0.95)
    g_smoke = Gaussians(
        sh_dc=rgb_to_sh(torch.full((n, 3), smoke_color,
                                   device=density.device)),
        opacity_logit=_logit(alpha), active=active, **base)
    fire_rgb = blackbody_rgb(t_sel) * (1.0 + 2.0 * t_sel[:, None])
    g_fire = Gaussians(
        sh_dc=rgb_to_sh(fire_rgb),
        opacity_logit=_logit(alpha * fire.to(torch.float32)),
        active=active & fire, **base)
    return g_smoke, g_fire
