"""Pinhole camera in the OpenCV/COLMAP convention (+z forward).

Counterpart of ``autovfx_tpu/core/cameras.py:29-195``.  ``R``/``t`` are
the world-to-camera rotation and translation (``p_cam = R @ p + t``);
the intrinsics are float32 tensors (0-d, or (B,) for a stacked batch)
and the image size is plain Python ints.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


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
    device="cpu",
) -> Camera:
    """Build a Camera from an OpenCV-convention camera-to-world matrix."""
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
    device="cpu",
) -> Camera:
    """OpenCV-convention look-at camera with the principal point at the
    image center."""
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
