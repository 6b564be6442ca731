"""Monocular normal maps for the trainer's normal regularizer.

Counterpart of ``autovfx_tpu/dataset/mono_normal.py`` (itself
``dataset_utils/get_mono_normal.py:9-69``): DSINE / Metric3D's
per-view ``<name>_normal.png`` files, in the reference's encoding
(inward normals mapped ``(n + 1) / 2`` to RGB), are read when present,
and otherwise normals come from a rendered depth by the cross product
of ``train/losses.depth_to_normal`` over the back-projected
camera-frame points.  The PNGs go through ``utils/png`` (the machine
with the card has no image library); the depth fallback runs on the
depth's device.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.cameras import Camera, index_camera
from autovfx_tpu_torch.utils import png


class PrecomputedNormalsMissing(RuntimeError):
    pass


def normal_map_path(output_dir: str, image_name: str) -> str:
    stem = os.path.splitext(image_name)[0]
    return os.path.join(output_dir, stem + "_normal.png")


def load_normal_map(path: str) -> np.ndarray:
    """Decode a reference-encoded normal PNG back to unit vectors in
    [-1, 1] (inward convention, get_mono_normal.py:17-19)."""
    rgb = png.read_rgb(path).astype(np.float32) / 255.0
    n = rgb * 2.0 - 1.0
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)


def save_normal_map(path: str, normals: np.ndarray) -> None:
    """Encode unit normals with the reference's (n+1)/2 mapping."""
    img = np.clip((np.asarray(normals) + 1.0) * 0.5 * 255.0, 0,
                  255).astype(np.uint8)
    png.write_png(path, img)


def normals_from_depth(depth: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(H, W, 3) camera-frame inward normals from a view-z depth map, on
    the depth's device.  Central differences; the one-pixel border,
    where a difference is missing, gets zero normals."""
    h, w = depth.shape
    dev = depth.device
    j, i = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    x = (i - cam.cx) / cam.fx * depth
    y = (j - cam.cy) / cam.fy * depth
    pts = torch.stack([x, y, depth], dim=-1)
    dx = torch.zeros_like(pts)
    dy = torch.zeros_like(pts)
    dx[:, 1:-1] = pts[:, 2:] - pts[:, :-2]
    dy[1:-1, :] = pts[2:, :] - pts[:-2, :]
    n = torch.linalg.cross(dy, dx, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    # inward convention: toward the camera means negative z in cam frame
    return torch.where(n[..., 2:3] > 0, -n, n)


def get_mono_normals(
    image_names: List[str],
    output_dir: str,
    depths: Optional[torch.Tensor] = None,
    cams: Optional[Camera] = None,
    device=devices.DEFAULT,
) -> torch.Tensor:
    """(F, H, W, 3) per-view normal maps on ``device``.

    Priority per view: precomputed ``<name>_normal.png`` (DSINE /
    Metric3D run offline, get_mono_normal.py contract), then normals
    from ``depths[i]`` and camera ``i``, then an error naming the
    missing inputs.
    """
    device = devices.resolve(device)
    out, missing = [], []
    for i, name in enumerate(image_names):
        p = normal_map_path(output_dir, name)
        if os.path.exists(p):
            out.append(torch.from_numpy(load_normal_map(p)).to(device))
        elif depths is not None and cams is not None:
            cam = index_camera(cams, i)
            depth = torch.as_tensor(depths[i], dtype=torch.float32,
                                    device=cam.R.device)
            out.append(normals_from_depth(depth, cam).to(device))
        else:
            missing.append(p)
    if missing:
        raise PrecomputedNormalsMissing(
            "no precomputed normal maps (run DSINE/Metric3D offline, "
            "get_mono_normal.py) and no depth fallback for: "
            + ", ".join(missing[:5])
        )
    return torch.stack(out)
