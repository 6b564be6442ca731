"""Pinhole camera in the OpenCV/COLMAP convention (+z forward).

Counterpart of ``autovfx_tpu/core/cameras.py`` (the camera :29-195,
the trajectory JSON and the field-of-view helpers :201-264).  ``R``/``t`` are
the world-to-camera rotation and translation (``p_cam = R @ p + t``);
the intrinsics are float32 tensors (0-d, or (B,) for a stacked batch)
and the image size is plain Python ints.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices

_CV_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Camera:
    R: torch.Tensor  # (3, 3) w2c rotation
    t: torch.Tensor  # (3,) w2c translation
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    @property
    def center(self) -> torch.Tensor:
        """Camera position in world space, ``-R^T t``."""
        return -torch.einsum("...ji,...j->...i", self.R, self.t)

    @property
    def c2w(self) -> torch.Tensor:
        """(..., 4, 4) camera-to-world, OpenCV convention."""
        top = torch.cat([self.R.transpose(-1, -2), self.center[..., :, None]],
                        dim=-1)
        return torch.cat([top, self._bottom_row(top)], dim=-2)

    @property
    def w2c(self) -> torch.Tensor:
        top = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        return torch.cat([top, self._bottom_row(top)], dim=-2)

    @staticmethod
    def _bottom_row(top: torch.Tensor) -> torch.Tensor:
        row = top.new_tensor([0.0, 0.0, 0.0, 1.0])
        return row.expand(*top.shape[:-2], 1, 4)

    @property
    def K(self) -> torch.Tensor:
        z, o = torch.zeros_like(self.fx), torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx], -1),
            torch.stack([z, self.fy, self.cy], -1),
            torch.stack([z, z, o], -1),
        ], dim=-2)

    def project(self, points_world: torch.Tensor):
        """World points (..., 3) -> pixel coords (..., 2) and view depth."""
        p = torch.einsum("ij,...j->...i", self.R, points_world) + self.t
        z = p[..., 2]
        u = self.fx * p[..., 0] / z + self.cx
        v = self.fy * p[..., 1] / z + self.cy
        return torch.stack([u, v], dim=-1), z

    def resized(self, factor: float) -> "Camera":
        """Downscale by ``factor`` (intrinsics divided, size rounded)."""
        return dataclasses.replace(
            self, fx=self.fx / factor, fy=self.fy / factor,
            cx=self.cx / factor, cy=self.cy / factor,
            width=round(self.width / factor),
            height=round(self.height / factor),
        )

    @property
    def tan_half_fovx(self) -> torch.Tensor:
        return 0.5 * self.width / self.fx

    @property
    def tan_half_fovy(self) -> torch.Tensor:
        return 0.5 * self.height / self.fy

    def ray_directions(self) -> torch.Tensor:
        """(H, W, 3) world-space directions (not normalized) of the rays
        through the pixel centers, at integer coordinates + 0.5."""
        dev = self.R.device
        j, i = torch.meshgrid(
            torch.arange(self.height, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(self.width, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij",
        )
        d = [(i - self.cx) / self.fx, (j - self.cy) / self.fy,
             torch.ones_like(i)]
        R = self.R
        # row vectors times R, i.e. R^T (camera -> world) applied to each
        return torch.stack(
            [d[0] * R[0, k] + d[1] * R[1, k] + d[2] * R[2, k]
             for k in range(3)], dim=-1)


_TENSOR_FIELDS = ("R", "t", "fx", "fy", "cx", "cy")


def camera_from_c2w(
    c2w: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    device=devices.DEFAULT,
) -> Camera:
    """Build a Camera from an OpenCV-convention camera-to-world matrix."""
    device = devices.resolve(device)
    w2c = np.linalg.inv(np.asarray(c2w, dtype=np.float64))
    f32 = lambda v: torch.tensor(np.float32(v), device=device)
    return Camera(
        R=torch.tensor(w2c[:3, :3].astype(np.float32), device=device),
        t=torch.tensor(w2c[:3, 3].astype(np.float32), device=device),
        fx=f32(fx),
        fy=f32(fy),
        cx=f32(cx),
        cy=f32(cy),
        width=int(width),
        height=int(height),
    )


def look_at_camera(
    eye, target, up, fx: float, fy: float, width: int, height: int,
    device=devices.DEFAULT,
) -> Camera:
    """OpenCV-convention look-at camera with the principal point at the
    image center."""
    device = devices.resolve(device)
    eye = np.asarray(eye, np.float64)
    forward = np.asarray(target, np.float64) - eye
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = forward
    c2w[:3, 3] = eye
    return camera_from_c2w(
        c2w, fx, fy, width / 2.0, height / 2.0, width, height, device=device
    )


def stack_cameras(cams: List[Camera]) -> Camera:
    """Stack same-size cameras into one batched Camera."""
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("stack_cameras needs cameras of one image size")
    return dataclasses.replace(
        cams[0],
        **{name: torch.stack([getattr(c, name) for c in cams])
           for name in _TENSOR_FIELDS},
    )


def index_camera(batch: Camera, i) -> Camera:
    return dataclasses.replace(
        batch, **{name: getattr(batch, name)[i] for name in _TENSOR_FIELDS}
    )


def num_cameras(batch: Camera) -> int:
    return batch.R.shape[0]


# ---- trajectory IO -------------------------------------------------------------


def load_custom_trajectory(path: str, downscale_factor: float = 1.0,
                           device=devices.DEFAULT):
    """Load a ``custom_camera_path/<name>.json`` trajectory: frames
    sorted by filename, their c2w as stored, shared intrinsics, an
    optional downscale.  Returns (batched Camera on ``device``, c2w
    (F, 4, 4) float32 numpy, filenames)."""
    device = devices.resolve(device)
    with open(path, "r") as f:
        traj = json.load(f)
    fx, fy, cx, cy = traj["fl_x"], traj["fl_y"], traj["cx"], traj["cy"]
    w, h = traj["w"], traj["h"]
    if downscale_factor > 1.0:
        h = round(h / downscale_factor)
        w = round(w / downscale_factor)
        fx, fy = fx / downscale_factor, fy / downscale_factor
        cx, cy = cx / downscale_factor, cy / downscale_factor
    frames = sorted(traj["frames"], key=lambda fr: fr["filename"])
    c2ws = np.array([fr["transform_matrix"] for fr in frames], np.float64)
    cams = [camera_from_c2w(c2w, fx, fy, cx, cy, w, h, device=device)
            for c2w in c2ws]
    names = [fr["filename"] for fr in frames]
    return stack_cameras(cams), c2ws.astype(np.float32), names


def save_custom_trajectory(path: str, cams: Camera, names=None) -> None:
    """Write a batched camera as the trajectory JSON."""
    n = num_cameras(cams)
    if names is None:
        names = [f"{i:05d}.png" for i in range(n)]
    host = lambda x: x.detach().cpu().numpy()
    c2w = host(cams.c2w)
    payload = {
        "fl_x": float(host(cams.fx)[0]),
        "fl_y": float(host(cams.fy)[0]),
        "cx": float(host(cams.cx)[0]),
        "cy": float(host(cams.cy)[0]),
        "w": int(cams.width),
        "h": int(cams.height),
        "frames": [
            {"filename": names[i], "transform_matrix": c2w[i].tolist()}
            for i in range(n)
        ],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def opencv_to_opengl_c2w(c2w_cv: np.ndarray) -> np.ndarray:
    """OpenCV c2w -> OpenGL/Blender c2w (y and z axes flipped)."""
    return np.asarray(c2w_cv, np.float32) @ _CV_TO_GL


def opengl_to_opencv_c2w(c2w_gl: np.ndarray) -> np.ndarray:
    return np.asarray(c2w_gl, np.float32) @ _CV_TO_GL
