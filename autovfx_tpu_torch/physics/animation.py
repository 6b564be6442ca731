"""Kinematic object animation (trajectory following).

A numpy counterpart of ``autovfx_tpu/physics/animation.py``.  Parity
target: ``blender/all_rendering.py:672-698, 867-927`` — animated
inserts follow a poly-curve trajectory (FOLLOW_PATH constraint) with the
object's forward axis tracking the direction of motion, plus cyclic
fcurve repetition for asset-embedded animations.  Objects with
``animation.type == 'trajectory'`` are KINEMATIC rigid bodies
(edit_utils.set_moving_animation:354-363): they push other bodies but
follow the prescribed path exactly.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

_FORWARD_AXIS = {
    # object-local axis that should face the direction of motion
    "TRACK_NEGATIVE_Y": np.array([0.0, -1.0, 0.0]),
    "FORWARD_Y": np.array([0.0, 1.0, 0.0]),
    "TRACK_NEGATIVE_X": np.array([-1.0, 0.0, 0.0]),
    "FORWARD_X": np.array([1.0, 0.0, 0.0]),
}


def interpolate_trajectory(
    points: np.ndarray, num_frames: int
) -> tuple[np.ndarray, np.ndarray]:
    """Arc-length-uniform positions + unit tangents along a polyline."""
    pts = np.asarray(points, np.float64)
    if len(pts) == 1:
        pos = np.repeat(pts, num_frames, 0)
        return pos.astype(np.float32), np.tile(
            np.array([1.0, 0, 0], np.float32), (num_frames, 1)
        )
    seg = np.diff(pts, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = max(cum[-1], 1e-9)
    s = np.linspace(0.0, total, num_frames)
    idx = np.clip(np.searchsorted(cum, s, side="right") - 1, 0,
                  len(seg) - 1)
    t = (s - cum[idx]) / np.maximum(seg_len[idx], 1e-9)
    pos = pts[idx] + t[:, None] * seg[idx]
    tangent = seg[idx] / np.maximum(seg_len[idx][:, None], 1e-9)
    return pos.astype(np.float32), tangent.astype(np.float32)


def animation_rotation(tangent: np.ndarray, forward_axis: str) -> np.ndarray:
    """(F, 3, 3) world rotations aligning the forward axis to the tangent
    (z-up heading, like Blender's FOLLOW_PATH with a z-up track)."""
    fwd_local = _FORWARD_AXIS.get(
        forward_axis, _FORWARD_AXIS["TRACK_NEGATIVE_Y"]
    )
    f = tangent.copy()
    f[:, 2] = 0.0  # heading only (vehicles stay upright)
    n = np.linalg.norm(f, axis=1, keepdims=True)
    f = np.where(n > 1e-6, f / np.maximum(n, 1e-9),
                 np.array([1.0, 0, 0]))
    # rotation about z taking fwd_local (xy part) to f
    a0 = np.arctan2(fwd_local[1], fwd_local[0])
    a1 = np.arctan2(f[:, 1], f[:, 0])
    ang = a1 - a0
    c, s = np.cos(ang), np.sin(ang)
    rots = np.zeros((len(tangent), 3, 3), np.float32)
    rots[:, 0, 0] = c
    rots[:, 0, 1] = -s
    rots[:, 1, 0] = s
    rots[:, 1, 1] = c
    rots[:, 2, 2] = 1.0
    return rots


def kinematic_schedule(
    objects: List[Dict], num_frames: int
) -> Optional[Dict[int, tuple]]:
    """Per-animated-object (positions (F,3), rotations (F,3,3)).

    Returns {body_index: (pos, rot)} for objects with trajectory
    animations; static animations hold their pose.
    """
    out = {}
    for i, obj in enumerate(objects):
        anim = obj.get("animation")
        if not anim:
            continue
        if anim.get("type") == "trajectory" and anim.get("points") is not None:
            pos, tang = interpolate_trajectory(
                np.asarray(anim["points"], np.float64), num_frames
            )
            rot = animation_rotation(tang, obj.get("forward_axis",
                                                   "TRACK_NEGATIVE_Y"))
            from autovfx_tpu_torch.physics.world import object_rotation

            rot = np.einsum("fij,jk->fik", rot, object_rotation(obj))
            out[i] = (pos, rot)
        elif anim.get("type") == "static":
            pos = np.tile(
                np.asarray(obj.get("pos", np.zeros(3)), np.float32),
                (num_frames, 1),
            )
            rot = np.tile(
                np.asarray(obj.get("rot", np.eye(3)), np.float32),
                (num_frames, 1, 1),
            )
            out[i] = (pos, rot)
    return out or None
