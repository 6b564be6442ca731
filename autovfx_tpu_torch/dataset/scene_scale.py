"""Scene metric-scale estimation.

Counterpart of ``autovfx_tpu/dataset/scene_scale.py`` (itself
``dataset_utils/estimate_scene_scale.py:17-125``): known objects'
masks in the anchor frame (RAM + GroundedSAM there, precomputed here)
are ray-cast onto the scene mesh for each object's observed extent,
GPT-4V (or the offline size table) gives its real size, and the scale
is the median of the ratios.  The rays are cast on the camera's
device with ``ops.raymesh.ray_mesh_first_hit``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from autovfx_tpu_torch.core.cameras import Camera
from autovfx_tpu_torch.edit.mesh_io import Mesh
from autovfx_tpu_torch.ops.raymesh import ray_mesh_first_hit
from autovfx_tpu_torch.perception.gpt4v import estimate_object_scale


def observed_object_extent(
    cam: Camera, mask: np.ndarray, mesh: Mesh, stride: int = 4
) -> float:
    """World-space extent (the diagonal of the hit points' box) of a
    masked object, from the rays through every ``stride``-th pixel."""
    ys, xs = np.nonzero(np.asarray(mask)[::stride, ::stride])
    if len(ys) < 4:
        return 0.0
    dev = cam.R.device
    ys = torch.from_numpy(ys * stride).to(dev)
    xs = torch.from_numpy(xs * stride).to(dev)
    rays = cam.ray_directions()[ys, xs]
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=1, keepdim=True),
                              min=1e-12)
    o = cam.center[None, :].expand(len(rays), 3)
    verts = torch.as_tensor(np.asarray(mesh.vertices, np.float32),
                            device=dev)
    faces = torch.as_tensor(np.asarray(mesh.faces, np.int64), device=dev)
    t, _, hit = ray_mesh_first_hit(o, rays, verts[faces[:, 0]],
                                   verts[faces[:, 1]], verts[faces[:, 2]])
    if int(hit.sum()) < 4:
        return 0.0
    pts = o[hit] + rays[hit] * t[hit, None]
    return float(torch.linalg.norm(pts.amax(0) - pts.amin(0)))


def estimate_scene_scale(
    cam: Camera,
    mesh: Mesh,
    object_masks: Dict[str, np.ndarray],
) -> float:
    """Median of (observed extent / real-world size) over the objects.

    The returned value is the reference's ``scene_scale`` (world units
    per meter, README.md:326; Garden: 2.67).
    """
    ratios: List[float] = []
    for name, mask in object_masks.items():
        extent = observed_object_extent(cam, mask, mesh)
        if extent <= 0:
            continue
        real = estimate_object_scale(None, name)
        if real > 0:
            ratios.append(extent / real)
    if not ratios:
        return 1.0
    return float(np.median(ratios))
