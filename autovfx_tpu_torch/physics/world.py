"""Rigid-body world: built from edit-IR objects, simulated, written back
as the ``rb_transform`` schema.

Counterpart of ``autovfx_tpu/physics/world.py``.  ``simulate`` runs the
frame loop on the world's device with no read back until its end.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.quaternion import (
    euler_to_rotmat,
    quat_to_rotmat,
    rotmat_to_quat,
)
from autovfx_tpu_torch.physics import solver as S
from autovfx_tpu_torch.physics.shapes import (
    ConvexHullShape,
    MeshGrid,
    build_hulls,
    build_mesh_grid,
)


def _f32_rotmat_to_quat(rot: np.ndarray) -> np.ndarray:
    return rotmat_to_quat(torch.tensor(np.asarray(rot, np.float32))).numpy()


def _f32_quat_to_rotmat(quat: np.ndarray) -> np.ndarray:
    return quat_to_rotmat(torch.tensor(np.asarray(quat, np.float32))).numpy()


def object_rotation(obj: dict) -> np.ndarray:
    """An edit-IR object's rotation: its 'rot' as a 3x3 matrix, or an
    XYZ Euler triple (the rb_transform convention)."""
    r_in = np.asarray(obj.get("rot", np.eye(3)), np.float32)
    if r_in.shape == (3, 3):
        return r_in
    return euler_to_rotmat(*[float(r) for r in r_in]).numpy()


class RigidWorld:
    """The hulls, the bodies' parameters and state, the scene grid and
    the solver's configuration, on one device."""

    def __init__(
        self,
        shape: ConvexHullShape,
        params: S.BodyParams,
        init_state: S.BodyState,
        grid: Optional[MeshGrid],
        cfg: S.SolverConfig,
        names: list,
        scales: np.ndarray,
        com_offsets: np.ndarray,
    ):
        self.shape = shape
        self.params = params
        self.state = init_state
        self.grid = grid
        self.cfg = cfg
        self.names = names
        self.scales = scales  # per-body uniform scale
        self.com_offsets = com_offsets  # mesh origin -> COM (world scale)

    @classmethod
    def from_objects(
        cls,
        objects: list,
        object_vertices: list,
        scene_vertices: Optional[np.ndarray] = None,
        scene_faces: Optional[np.ndarray] = None,
        cfg: S.SolverConfig = S.SolverConfig(),
        device=devices.DEFAULT,
    ) -> "RigidWorld":
        """From edit-IR object dicts (pos, rot as a 3x3 matrix or an XYZ
        Euler triple, scale, rigid_body {rb_type, mass, restitution},
        allow_physics) and their mesh vertices (object frame); the scene
        mesh, when given, is the static collider."""
        device = devices.resolve(device)
        b = len(objects)
        hull_pts, poss, quats, scales = [], [], [], []
        mass, rest, rb_type, enabled, names = [], [], [], [], []
        for obj, verts in zip(objects, object_vertices):
            s = float(obj.get("scale", 1.0))
            hull_pts.append(np.asarray(verts) * s)
            quats.append(_f32_rotmat_to_quat(object_rotation(obj)))
            poss.append(np.asarray(obj.get("pos", [0.0, 0.0, 0.0]),
                                   np.float32))
            scales.append(s)
            rb = obj.get("rigid_body") or {}
            mass.append(float(rb.get("mass", 1.0)))
            rest.append(float(rb.get("restitution", 0.6)))
            t = str(rb.get("rb_type", "ACTIVE")).upper()
            rb_type.append({"ACTIVE": S.RB_ACTIVE, "PASSIVE": S.RB_PASSIVE,
                            "KINEMATIC": S.RB_KINEMATIC}[t])
            enabled.append(bool(obj.get("allow_physics", True)))
            names.append(obj.get("object_id", obj.get("object_name", "obj")))

        shape, coms, _, inertias = build_hulls(hull_pts, device=device)

        # the state's positions are COMs: world_com = pos + R·com
        poss = np.stack(poss)
        quats_np = np.stack(quats)
        rots = _f32_quat_to_rotmat(quats_np)
        world_com = poss + np.einsum("bij,bj->bi", rots, coms)

        rb_type = np.array(rb_type, np.int32)
        mass = np.array(mass, np.float32)
        inv_mass = np.where(rb_type == S.RB_ACTIVE, 1.0 / mass, 0.0)
        t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt,
                                                     device=device)
        params = S.BodyParams(
            mass=t(mass),
            inv_mass=t(inv_mass.astype(np.float32)),
            inertia_body=t(inertias),
            restitution=t(np.array(rest, np.float32)),
            friction=t(np.full((b,), 0.5, np.float32)),
            rb_type=t(rb_type, torch.int32),
            enabled=t(np.array(enabled), torch.bool),
        )
        state = S.BodyState(
            pos=t(world_com.astype(np.float32)),
            quat=t(quats_np.astype(np.float32)),
            linvel=torch.zeros((b, 3), device=device),
            angvel=torch.zeros((b, 3), device=device),
            asleep=torch.zeros((b,), dtype=torch.bool, device=device),
            low_vel_count=torch.zeros((b,), dtype=torch.int32, device=device),
        )
        grid = None
        if scene_vertices is not None:
            grid = build_mesh_grid(scene_vertices, scene_faces, device=device)
        return cls(shape, params, state, grid, cfg, names,
                   np.array(scales, np.float32), coms.astype(np.float32))


def simulate(
    world: RigidWorld,
    num_frames: int,
    enabled_schedule=None,
    kinematic=None,
    return_impacts: bool = False,
):
    """Run the frame loop: (final BodyState, pos (F, B, 3), quat (F, B, 4))
    of the centers of mass as numpy, read back once at the end.

    ``enabled_schedule``: (F, B) bool, per-frame physics on/off.
    ``kinematic``: {body: (pos (F, 3), rot (F, 3, 3))} of mesh-origin
    poses (``animation.kinematic_schedule``); such a body follows them
    with a velocity derived per frame, so it pushes active bodies.
    ``return_impacts`` adds (F, B), each body's largest contact approach
    speed in the frame (the signal of a collision-triggered fracture).
    """
    cfg = world.cfg
    shape, params, grid = world.shape, world.params, world.grid
    dev = world.state.pos.device
    b = world.state.pos.shape[0]
    if enabled_schedule is None:
        sched = params.enabled[None, :].expand(num_frames, b)
    else:
        sched = torch.tensor(np.asarray(enabled_schedule, bool), device=dev)

    kin_mask = np.zeros((b,), bool)
    kin_pos = np.zeros((num_frames, b, 3), np.float32)
    kin_quat = np.zeros((num_frames, b, 4), np.float32)
    kin_quat[..., 0] = 1.0
    if kinematic:
        for i, (pos_f, rot_f) in kinematic.items():
            kin_mask[i] = True
            qs = _f32_rotmat_to_quat(rot_f)
            # the COM trajectory: com = pos + R·com_offset
            com = pos_f + np.einsum("fij,j->fi", np.asarray(rot_f),
                                    world.com_offsets[i])
            kin_pos[:, i] = com[:num_frames]
            kin_quat[:, i] = qs[:num_frames]
    has_kinematic = bool(np.any(kin_mask))
    m = torch.tensor(kin_mask, device=dev)
    kin_pos_t = torch.tensor(kin_pos, device=dev)
    kin_quat_t = torch.tensor(kin_quat, device=dev)
    kin_pos_next = torch.cat([kin_pos_t[1:], kin_pos_t[-1:]], dim=0)
    zero = torch.zeros((), device=dev)

    state = world.state
    pos_out, quat_out, impact_out = [], [], []
    for f in range(num_frames):
        params_f = params.replace(enabled=sched[f])
        if has_kinematic:
            vel_kin = (kin_pos_next[f] - kin_pos_t[f]) * cfg.fps
            mm = m[:, None]
            state = state.replace(
                pos=torch.where(mm, kin_pos_t[f], state.pos),
                quat=torch.where(mm, kin_quat_t[f], state.quat),
                linvel=torch.where(mm, vel_kin, state.linvel),
                angvel=torch.where(mm, zero, state.angvel),
                asleep=state.asleep & ~m,
            )
        impacts = []
        for _ in range(cfg.substeps_per_frame):
            state, impact = S.substep(shape, state, params_f, grid, cfg)
            impacts.append(impact)
        pos_out.append(state.pos)
        quat_out.append(state.quat)
        impact_out.append(torch.stack(impacts).amax(0))
    pos = torch.stack(pos_out).cpu().numpy()
    quat = torch.stack(quat_out).cpu().numpy()
    if return_impacts:
        return state, pos, quat, torch.stack(impact_out).cpu().numpy()
    return state, pos, quat


def origin_trajectory(world: RigidWorld, pos: np.ndarray, quat: np.ndarray):
    """Mesh-origin (traj_pos (F, B, 3), traj_rot (F, B, 3, 3)) float32 from
    a COM trajectory, for ``render.clip.build_clip_inputs``."""
    f = pos.shape[0]
    rots = _f32_quat_to_rotmat(quat.reshape(-1, 4)).reshape(f, -1, 3, 3)
    origin = pos - np.einsum("fbij,bj->fbi", rots, world.com_offsets)
    return origin.astype(np.float32), rots.astype(np.float32)


def rb_transform_schema(world: RigidWorld, pos: np.ndarray,
                        quat: np.ndarray) -> dict:
    """The Blender ``rb_transform`` dict, {object_id: {frame (str): {pos,
    rot (XYZ Euler, radians), scale}}}, with mesh-origin positions."""
    f = pos.shape[0]
    rots = _f32_quat_to_rotmat(quat.reshape(-1, 4)).reshape(f, -1, 3, 3)
    out = {}
    for i, name in enumerate(world.names):
        frames = {}
        for t in range(f):
            r = rots[t, i]
            origin = pos[t, i] - r @ world.com_offsets[i]
            sy = -r[2, 0]
            cy = np.sqrt(max(1.0 - sy * sy, 0.0))
            if cy > 1e-6:
                rx = np.arctan2(r[2, 1], r[2, 2])
                ry = np.arcsin(np.clip(sy, -1, 1))
                rz = np.arctan2(r[1, 0], r[0, 0])
            else:
                rx = np.arctan2(-r[1, 2], r[1, 1])
                ry = np.arcsin(np.clip(sy, -1, 1))
                rz = 0.0
            frames[str(t)] = {
                "pos": [float(x) for x in origin],
                "rot": [float(rx), float(ry), float(rz)],
                "scale": [float(world.scales[i])] * 3,
            }
        out[name] = frames
    return out
