"""Impulse-based rigid-body solver (Bullet's step, as AutoVFX configures it).

Counterpart of ``autovfx_tpu/physics/solver.py``: restitution 0.6 for
the scene, collision margin 1e-3, friction 0.5, 60 substeps a second at
15 fps, 10 solver iterations, gravity (0, 0, -9.81).  Contacts are
fixed-budget vertex manifolds (hull vertex vs the scene-mesh grid, hull
vertex vs hull by face-normal SAT), solved by Jacobi sweeps of
sequential impulses with mass splitting, split restitution and
friction impulses, and a positional correction pass.

Every sum over contacts into bodies is a masked reduction over a
(contacts × bodies) one-hot, never a scatter-add: on the card a
scatter-add sums in no fixed order, and inside ten Jacobi iterations
that makes two runs' trajectories differ.  The substep reads nothing
back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from autovfx_tpu_torch.core.quaternion import (
    helper_axis,
    quat_integrate,
    quat_to_rotmat,
)
from autovfx_tpu_torch.physics.shapes import (
    ConvexHullShape,
    MeshGrid,
    mesh_contact_query,
)
from autovfx_tpu_torch.utils.gather import take

GRAVITY = (0.0, 0.0, -9.81)

# rb_type codes (edit IR ``rigid_body.rb_type``)
RB_ACTIVE = 0
RB_PASSIVE = 1
RB_KINEMATIC = 2


@dataclasses.dataclass(frozen=True)
class BodyState:
    pos: torch.Tensor  # (B, 3) center of mass, world
    quat: torch.Tensor  # (B, 4) wxyz
    linvel: torch.Tensor  # (B, 3)
    angvel: torch.Tensor  # (B, 3) world frame
    asleep: torch.Tensor  # (B,) bool
    low_vel_count: torch.Tensor  # (B,) int32 consecutive slow substeps

    def replace(self, **kw) -> "BodyState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BodyParams:
    mass: torch.Tensor  # (B,)
    inv_mass: torch.Tensor  # (B,) 0 for non-active
    inertia_body: torch.Tensor  # (B, 3, 3) unit-mass inertia, body frame
    restitution: torch.Tensor  # (B,)
    friction: torch.Tensor  # (B,)
    rb_type: torch.Tensor  # (B,) int32
    enabled: torch.Tensor  # (B,) bool: physics on

    def replace(self, **kw) -> "BodyParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    substeps_per_frame: int = 4
    fps: float = 15.0
    solver_iterations: int = 10
    collision_margin: float = 1e-3
    baumgarte: float = 0.2
    slop: float = 1e-3
    restitution_threshold: float = 0.5  # no bounce below this approach
    # deactivation (Bullet: linear 0.4, angular 0.5, ~0.5 s of rest)
    sleep_lin: float = 0.4
    sleep_ang: float = 0.5
    sleep_substeps: int = 30
    wake_speed: float = 0.5
    # speculative contact distance: contacts activate within it and the
    # velocity solve removes only the approach that would penetrate
    speculative: float = 0.05


class Contacts(NamedTuple):
    body_a: torch.Tensor  # (K,) int64, receives the +normal impulse
    body_b: torch.Tensor  # (K,) int64, the other body, -1 = the scene
    point: torch.Tensor  # (K, 3)
    normal: torch.Tensor  # (K, 3) from b (or the scene) toward a
    depth: torch.Tensor  # (K,) penetration, > 0 interpenetrating
    valid: torch.Tensor  # (K,)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _world_verts(shape: ConvexHullShape, state: BodyState) -> torch.Tensor:
    rot = quat_to_rotmat(state.quat)
    return torch.einsum("bij,bvj->bvi", rot, shape.verts) + state.pos[:, None]


def _active(params: BodyParams, state: BodyState) -> torch.Tensor:
    return (params.rb_type == RB_ACTIVE) & params.enabled & ~state.asleep


def gen_scene_contacts(
    shape: ConvexHullShape,
    state: BodyState,
    params: BodyParams,
    grid: MeshGrid,
    margin: float,
    speculative: float = 0.05,
) -> Contacts:
    """Hull-vertex vs scene-mesh contacts, one candidate per vertex."""
    b, v, _ = shape.verts.shape
    wv = _world_verts(shape, state).reshape(b * v, 3)
    dist, normal, _ = mesh_contact_query(grid, wv)
    active = _active(params, state)
    per_vertex = lambda x: x[:, None].expand(b, v).reshape(-1)  # no sync
    mask = (shape.vert_mask.reshape(-1) & per_vertex(active)
            & (dist < margin + speculative) & torch.isfinite(dist))
    depth = margin - dist  # negative: speculative, not yet touching
    body_a = per_vertex(torch.arange(b, device=wv.device))
    return Contacts(
        body_a=body_a,
        body_b=torch.full_like(body_a, -1),
        point=wv,
        normal=normal,
        depth=torch.where(mask, depth, torch.zeros_like(depth)),
        valid=mask,
    )


def gen_pair_contacts(
    shape: ConvexHullShape,
    state: BodyState,
    params: BodyParams,
    margin: float,
    contact_tol: float = 0.05,
) -> Contacts:
    """Hull-hull contacts by face-normal SAT and deepest-vertex manifolds:
    for each ordered pair (a, b), a's vertices within ``contact_tol`` of
    the deepest along b's least-penetration face (edge-edge axes are
    left out, as in the reference)."""
    b, v, _ = shape.verts.shape
    dev = shape.verts.device
    wv = _world_verts(shape, state)
    rot = quat_to_rotmat(state.quat)
    n_w = torch.einsum("bij,bfj->bfi", rot, shape.planes[..., :3])
    d_w = shape.planes[..., 3] + torch.einsum("bfi,bi->bf", n_w, state.pos)

    inf = float("inf")
    # sd[a, b, v, f]: signed distance of a's vertex v to b's plane f
    sd = torch.einsum("bfi,avi->abvf", n_w, wv) - d_w[None, :, None, :]
    sd = torch.where(shape.vert_mask[:, None, :, None], sd,
                     torch.full_like(sd, inf))
    face_sep = sd.amin(dim=2)  # (A, B, F)
    face_sep = torch.where(shape.plane_mask[None], face_sep,
                           torch.full_like(face_sep, -inf))
    sep_ab, best_f = torch.max(face_sep, dim=-1)  # first index on ties
    sep_pair = torch.maximum(sep_ab, sep_ab.T)

    ids = torch.arange(b, device=dev)
    same = ids[:, None] == ids[None, :]
    center_d = torch.linalg.norm(state.pos[:, None] - state.pos[None, :],
                                 dim=-1)
    sphere_ok = center_d < (shape.radius[:, None] + shape.radius[None, :]
                            + margin)
    movable = (params.rb_type == RB_ACTIVE) & params.enabled
    either_active = movable[:, None] | movable[None, :]
    collidable = (params.enabled[:, None] & params.enabled[None, :]
                  & (~state.asleep[:, None] | ~state.asleep[None, :]))
    pair_ok = ~same & sphere_ok & either_active & collidable
    touching = (sep_pair < margin + contact_tol) & pair_ok
    use_ab = touching & (sep_ab >= sep_ab.T)

    sd_best = torch.take_along_dim(
        sd, best_f[:, :, None, None].expand(b, b, v, 1), dim=-1)[..., 0]
    mask = (use_ab[:, :, None] & (sd_best <= sep_ab[:, :, None] + contact_tol)
            & (sd_best < margin + contact_tol) & shape.vert_mask[:, None, :])

    normal = n_w[ids[None, :, None], best_f[:, :, None]]  # b's best face
    normal = normal.expand(b, b, v, 3)
    depth = torch.where(mask, margin - sd_best, torch.zeros_like(sd_best))
    body_a = ids[:, None, None].expand(b, b, v).reshape(-1)
    body_b = ids[None, :, None].expand(b, b, v).reshape(-1)
    return Contacts(
        body_a=body_a,
        body_b=body_b,
        point=wv[:, None].expand(b, b, v, 3).reshape(-1, 3),
        normal=normal.reshape(-1, 3),
        depth=depth.reshape(-1),
        valid=mask.reshape(-1),
    )


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (..., 3, 3) matrices by the adjugate (no LU, so no
    pivoting decisions and no error check that reads back to the host)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


def _inv_inertia_world(params: BodyParams, state: BodyState) -> torch.Tensor:
    rot = quat_to_rotmat(state.quat)
    i_body = params.inertia_body * params.mass[:, None, None]
    i_world = rot @ i_body @ rot.transpose(-1, -2)
    eye = torch.eye(3, dtype=i_world.dtype, device=i_world.device)
    inv = _inv3(i_world + 1e-9 * eye)
    return inv * (params.inv_mass > 0).to(inv.dtype)[:, None, None]


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(K, n) bool, row k set at idx[k] (no column where idx < 0)."""
    return idx[:, None] == torch.arange(n, device=idx.device)[None, :]


def _sum_into(onehot: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(n, 3): each body's sum of the rows of ``values`` (K, 3) that
    ``onehot`` (K, n) gives it, in a fixed order."""
    z = torch.zeros((), dtype=values.dtype, device=values.device)
    return torch.where(onehot[:, :, None], values[:, None, :], z).sum(0)


def solve_velocities(
    contacts: Contacts,
    state: BodyState,
    params: BodyParams,
    cfg: SolverConfig,
    dt: float,
):
    """Iterated normal + Coulomb-friction impulses, batch Jacobi with
    mass splitting.  Returns the new state and each body's impact speed
    (its contacts' largest pre-solve approach speed)."""
    inv_i = _inv_inertia_world(params, state)
    n_bodies = state.pos.shape[0]
    a = contacts.body_a
    b_raw = contacts.body_b
    is_static = b_raw < 0
    b = torch.clamp(b_raw, min=0)
    zero = torch.zeros((), dtype=state.pos.dtype, device=state.pos.device)

    ra = contacts.point - take(state.pos, a)
    rb = contacts.point - take(state.pos, b)
    n = contacts.normal
    inv_ma = take(params.inv_mass, a)
    inv_mb = torch.where(is_static, zero, take(params.inv_mass, b))
    inv_ia = take(inv_i, a)
    inv_ib = torch.where(is_static[:, None, None], zero, take(inv_i, b))

    # a body of the pair gets the impulse; the scene takes none
    hot_a = _onehot(a, n_bodies)
    hot_b = _onehot(torch.where(is_static, -1, b), n_bodies)

    # Jacobi mass splitting: each body's compliance scaled by its count
    # of valid contacts (redundant manifolds otherwise diverge)
    vf = contacts.valid.to(state.pos.dtype)
    cnt = (torch.where(hot_a, vf[:, None], zero).sum(0)
           + torch.where(hot_b, vf[:, None], zero).sum(0))
    cnt_a = torch.clamp(take(cnt, a), min=1.0)
    cnt_b = torch.clamp(torch.where(is_static, 1.0, take(cnt, b)), min=1.0)

    def k_normal(axis):
        ta = _cross(ra, axis)
        tb = _cross(rb, axis)
        term_a = inv_ma + torch.sum(
            ta * torch.einsum("kij,kj->ki", inv_ia, ta), -1)
        term_b = inv_mb + torch.sum(
            tb * torch.einsum("kij,kj->ki", inv_ib, tb), -1)
        return cnt_a * term_a + cnt_b * term_b

    kn = torch.clamp(k_normal(n), min=1e-9)

    def rel_vel(linvel, angvel):
        va = take(linvel, a) + _cross(take(angvel, a), ra)
        vb = torch.where(is_static[:, None], zero,
                         take(linvel, b) + _cross(take(angvel, b), rb))
        return va - vb

    v0 = rel_vel(state.linvel, state.angvel)
    vn0 = torch.sum(v0 * n, -1)
    # restitution combines multiplicatively; the scene's is 0.6
    rest = take(params.restitution, a) * torch.where(
        is_static, 0.6, take(params.restitution, b))
    bounce = torch.where(-vn0 > cfg.restitution_threshold, -rest * vn0, zero)
    gap = torch.clamp(-contacts.depth, min=0.0)
    target = torch.where(bounce > 0.0, bounce, -gap / dt)

    fric = torch.sqrt(take(params.friction, a)
                      * torch.where(is_static, 0.5, take(params.friction, b)))

    t1 = _cross(n, helper_axis(n, 0.9))
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True),
                          min=1e-9)
    t2 = _cross(n, t1)
    kt1 = torch.clamp(k_normal(t1), min=1e-9)
    kt2 = torch.clamp(k_normal(t2), min=1e-9)

    def apply_impulses(linvel, angvel, imp):
        dv_a = imp * inv_ma[:, None]
        dw_a = torch.einsum("kij,kj->ki", inv_ia, _cross(ra, imp))
        dv_b = -imp * inv_mb[:, None]
        dw_b = -torch.einsum("kij,kj->ki", inv_ib, _cross(rb, imp))
        linvel = linvel + _sum_into(hot_a, dv_a) + _sum_into(hot_b, dv_b)
        angvel = angvel + _sum_into(hot_a, dw_a) + _sum_into(hot_b, dw_b)
        return linvel, angvel

    linvel, angvel = state.linvel, state.angvel
    pn_acc = pt1_acc = pt2_acc = torch.zeros_like(vf)
    for _ in range(cfg.solver_iterations):
        v = rel_vel(linvel, angvel)
        vn = torch.sum(v * n, -1)
        dpn = (target - vn) / kn * vf
        pn_new = torch.clamp(pn_acc + dpn, min=0.0)
        dpn = pn_new - pn_acc

        vt1 = torch.sum(v * t1, -1)
        vt2 = torch.sum(v * t2, -1)
        dpt1 = -vt1 / kt1 * vf
        dpt2 = -vt2 / kt2 * vf
        max_f = fric * pn_new
        pt1_new = torch.clamp(pt1_acc + dpt1, -max_f, max_f)
        pt2_new = torch.clamp(pt2_acc + dpt2, -max_f, max_f)
        dpt1 = pt1_new - pt1_acc
        dpt2 = pt2_new - pt2_acc

        imp = dpn[:, None] * n + dpt1[:, None] * t1 + dpt2[:, None] * t2
        pn_acc = pn_acc + dpn
        pt1_acc = pt1_acc + dpt1
        pt2_acc = pt2_acc + dpt2
        linvel, angvel = apply_impulses(linvel, angvel, imp)

    # non-active bodies keep their prescribed velocities
    active = ((params.rb_type == RB_ACTIVE) & params.enabled)[:, None]
    linvel = torch.where(active, linvel, state.linvel)
    angvel = torch.where(active, angvel, state.angvel)

    # per-body impact speed: the largest pre-solve approach speed of its
    # valid contacts (a max: order-free)
    approach = torch.where(contacts.valid, torch.clamp(-vn0, min=0.0), zero)
    impact = torch.maximum(
        torch.where(hot_a, approach[:, None], zero).amax(0),
        torch.where(hot_b, approach[:, None], zero).amax(0))
    return state.replace(linvel=linvel, angvel=angvel), impact


def position_correction(
    contacts: Contacts,
    state: BodyState,
    params: BodyParams,
    cfg: SolverConfig,
    iters: int = 4,
) -> BodyState:
    """Split-impulse positional projection (linear pseudo-impulses only):
    removes what penetration remains without adding kinetic energy."""
    n_bodies = state.pos.shape[0]
    a = contacts.body_a
    b_raw = contacts.body_b
    is_static = b_raw < 0
    b = torch.clamp(b_raw, min=0)
    n = contacts.normal
    zero = torch.zeros((), dtype=state.pos.dtype, device=state.pos.device)
    inv_ma = take(params.inv_mass, a)
    inv_mb = torch.where(is_static, zero, take(params.inv_mass, b))
    k = torch.clamp(inv_ma + inv_mb, min=1e-9)
    vf = contacts.valid.to(state.pos.dtype)
    hot_a = _onehot(a, n_bodies)
    hot_b = _onehot(torch.where(is_static, -1, b), n_bodies)

    dpos = torch.zeros_like(state.pos)
    for _ in range(iters):
        sep = torch.sum((take(dpos, a) - torch.where(is_static[:, None], zero,
                                               take(dpos, b))) * n, -1)
        depth_now = contacts.depth - sep
        p = (cfg.baumgarte * torch.clamp(depth_now - cfg.slop, min=0.0)
             / k * vf)
        dpos = (dpos + _sum_into(hot_a, 0.7 * p[:, None] * n * inv_ma[:, None])
                + _sum_into(hot_b, -0.7 * p[:, None] * n * inv_mb[:, None]))
    active = _active(params, state)[:, None]
    return state.replace(pos=state.pos + torch.where(active, dpos, zero))


def _cat_contacts(sets) -> Contacts:
    return Contacts(*(torch.cat(fields) for fields in zip(*sets)))


def substep(
    shape: ConvexHullShape,
    state: BodyState,
    params: BodyParams,
    grid: Optional[MeshGrid],
    cfg: SolverConfig,
):
    """One substep: gravity, contacts, the velocity solve, positional
    correction, sleeping, integration.  Returns (state, impact (B,))."""
    dt = 1.0 / (cfg.fps * cfg.substeps_per_frame)
    zero = torch.zeros((), dtype=state.pos.dtype, device=state.pos.device)
    active = _active(params, state)[:, None]
    v = state.linvel  # gravity pulls along z only (made on the device)
    fall = torch.cat([v[:, :2], v[:, 2:] + dt * torch.full_like(
        v[:, 2:], GRAVITY[2])], dim=1)
    state = state.replace(linvel=torch.where(active, fall, v))

    contact_sets = []
    if grid is not None:
        contact_sets.append(gen_scene_contacts(
            shape, state, params, grid, cfg.collision_margin,
            cfg.speculative))
    contact_sets.append(gen_pair_contacts(
        shape, state, params, cfg.collision_margin, cfg.speculative))
    contacts = _cat_contacts(contact_sets)
    state, impact = solve_velocities(contacts, state, params, cfg, dt)
    state = position_correction(contacts, state, params, cfg)

    # deactivation: wake bodies hit by a fast-approaching contact
    n_bodies = state.pos.shape[0]
    ba, bb = contacts.body_a, contacts.body_b
    static = bb < 0
    b_safe = torch.clamp(bb, min=0)
    va = take(state.linvel, ba) + _cross(take(state.angvel, ba),
                                   contacts.point - take(state.pos, ba))
    vb = torch.where(static[:, None], zero, take(state.linvel, b_safe) + _cross(
        take(state.angvel, b_safe), contacts.point - take(state.pos, b_safe)))
    vn_now = torch.abs(torch.sum((va - vb) * contacts.normal, -1))
    fast = contacts.valid & (vn_now > cfg.wake_speed)
    wake = ((_onehot(ba, n_bodies) & fast[:, None]).any(0)
            | (_onehot(torch.where(static, -1, bb), n_bodies)
               & fast[:, None]).any(0))

    low = ((torch.linalg.norm(state.linvel, dim=-1) < cfg.sleep_lin)
           & (torch.linalg.norm(state.angvel, dim=-1) < cfg.sleep_ang))
    count = torch.where(low & ~wake, state.low_vel_count + 1,
                        torch.zeros_like(state.low_vel_count))
    asleep = (state.asleep & ~wake) | (count >= cfg.sleep_substeps)
    still = asleep[:, None]
    state = state.replace(
        linvel=torch.where(still, zero, state.linvel),
        angvel=torch.where(still, zero, state.angvel),
        asleep=asleep,
        low_vel_count=count,
    )

    # integration; kinematic bodies follow their animation velocity
    movable = (((params.rb_type == RB_ACTIVE)
                | (params.rb_type == RB_KINEMATIC))
               & params.enabled & ~state.asleep)[:, None]
    pos = torch.where(movable, state.pos + dt * state.linvel, state.pos)
    quat = torch.where(movable, quat_integrate(state.quat, state.angvel, dt),
                       state.quat)
    return state.replace(pos=pos, quat=quat), impact
