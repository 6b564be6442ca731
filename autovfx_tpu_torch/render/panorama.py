"""Panorama rendering: a six-view cubemap resampled to an equirect.

Counterpart of ``autovfx_tpu/render/panorama.py``: six 90° cube faces
rendered from a center point through ``ops.rasterize.rasterize``
(kernels 1-3 once a face on the card), then resampled on the host into
an equirectangular panorama (the emitter maps of indoor scenes).
"""
from __future__ import annotations

import numpy as np

from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize

# cube face orientations: (forward, up) in the world, OpenCV convention
FACES = [
    ([1, 0, 0], [0, 0, 1]),
    ([-1, 0, 0], [0, 0, 1]),
    ([0, 1, 0], [0, 0, 1]),
    ([0, -1, 0], [0, 0, 1]),
    ([0, 0, 1], [0, 1, 0]),
    ([0, 0, -1], [0, 1, 0]),
]


def face_cameras(center, face_size: int, device) -> list:
    """The six 90° cube-face cameras at ``center``."""
    center = np.asarray(center, np.float64)
    fx = face_size / 2.0
    return [C.look_at_camera(center, center + np.asarray(fwd, np.float64), up,
                             fx=fx, fy=fx, width=face_size, height=face_size,
                             device=device)
            for fwd, up in FACES]


def render_panorama(
    g: Gaussians,
    center: np.ndarray,
    face_size: int = 512,
    out_height: int = 512,
    config: RasterConfig = RasterConfig(),
) -> np.ndarray:
    """(H, 2H, 3) float32 equirect panorama rendered from ``center``, the
    faces on the scene's device."""
    fx = face_size / 2.0
    faces, face_mats = [], []
    for cam in face_cameras(center, face_size, g.xyz.device):
        faces.append(rasterize(g, cam, config=config).color.cpu().numpy())
        face_mats.append(cam.R.cpu().numpy())

    # equirect resample: direction per pixel -> face + uv
    h = out_height
    w = 2 * h
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    theta = vv * np.pi
    phi = (uu - 0.5) * 2 * np.pi
    st = np.sin(theta)
    # render/envmap.py's direction convention
    dirs = np.stack([-st * np.cos(phi), -st * np.sin(phi), np.cos(theta)],
                    axis=-1)

    pano = np.zeros((h, w, 3), np.float32)
    best = np.full((h, w), -np.inf)
    for img, rm in zip(faces, face_mats):
        d_cam = dirs @ rm.T  # world -> camera
        z = d_cam[..., 2]
        px = fx * d_cam[..., 0] / np.maximum(z, 1e-9) + face_size / 2
        py = fx * d_cam[..., 1] / np.maximum(z, 1e-9) + face_size / 2
        ok = ((z > 0) & (px >= 0) & (px < face_size - 1)
              & (py >= 0) & (py < face_size - 1) & (z > best))
        xi = np.clip(px.astype(int), 0, face_size - 1)
        yi = np.clip(py.astype(int), 0, face_size - 1)
        pano[ok] = img[yi[ok], xi[ok]]
        best = np.where(ok, z, best)
    return pano
