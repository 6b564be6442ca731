"""Custom camera trajectories.

Counterpart of ``autovfx_tpu/dataset/trajectories.py`` (itself
``dataset_utils/sample_custom_traj.py:53-133``): look-at orbits on a
half sphere and a figure-eight fly-through at the Garden default
intrinsics (1296×840, fx ≈ 960.98, fy ≈ 963.15, :126-132), written in
the ``custom_camera_path`` JSON schema that
``core.cameras.load_custom_trajectory`` reads.
"""
from __future__ import annotations

import numpy as np

from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import device as devices

GARDEN_INTRINSICS = dict(
    fx=960.98, fy=963.15, width=1296, height=840
)


def half_sphere_trajectory(
    center,
    radius: float,
    height: float,
    num_frames: int = 60,
    start_angle: float = 0.0,
    sweep: float = 2 * np.pi,
    fx: float = GARDEN_INTRINSICS["fx"],
    fy: float = GARDEN_INTRINSICS["fy"],
    width: int = GARDEN_INTRINSICS["width"],
    height_px: int = GARDEN_INTRINSICS["height"],
    device=devices.DEFAULT,
) -> C.Camera:
    """Orbit on a half-sphere looking at ``center``."""
    device = devices.resolve(device)
    center = np.asarray(center, np.float64)
    cams = []
    for i in range(num_frames):
        a = start_angle + sweep * i / max(num_frames - 1, 1)
        eye = center + np.array(
            [radius * np.cos(a), radius * np.sin(a), height]
        )
        cams.append(
            C.look_at_camera(
                eye, center, [0, 0, 1], fx=fx, fy=fy, width=width,
                height=height_px, device=device,
            )
        )
    return C.stack_cameras(cams)


def lemniscate_trajectory(
    center,
    radius: float,
    height: float,
    num_frames: int = 60,
    device=devices.DEFAULT,
    **intr,
) -> C.Camera:
    """Figure-eight fly-through (common novel-view demo path)."""
    device = devices.resolve(device)
    center = np.asarray(center, np.float64)
    cams = []
    kw = {**GARDEN_INTRINSICS, **intr}
    for i in range(num_frames):
        t = 2 * np.pi * i / max(num_frames - 1, 1)
        eye = center + np.array(
            [
                radius * np.cos(t),
                radius * np.sin(t) * np.cos(t),
                height + 0.1 * radius * np.sin(t),
            ]
        )
        cams.append(
            C.look_at_camera(
                eye, center, [0, 0, 1], fx=kw["fx"], fy=kw["fy"],
                width=kw["width"], height=kw["height"], device=device,
            )
        )
    return C.stack_cameras(cams)


def save_trajectory(path: str, cams: C.Camera) -> None:
    C.save_custom_trajectory(path, cams)
