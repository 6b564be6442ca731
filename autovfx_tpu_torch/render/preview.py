"""Asset preview renders: turntable views of an asset for the GPT-4V
scale and axis estimates.

Counterpart of ``autovfx_tpu/render/preview.py`` (which replaces the
reference's ``blender/asset_rendering.py:265-293``): the asset,
normalized to the unit box, is sampled into 40,000 surfels, shaded under
a constant white envmap and rendered through kernels 1-3 (on the card)
from ``num_views`` cameras around it at ``size``², budget 2^18, on a white
background; the PNGs go to ``<output_dir>/<object_id>/NNN.png``, the
contract ``edit_utils.retrieve_asset`` reads.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.cameras import Camera, look_at_camera
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.edit import mesh_io
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.render import ibl, meshsplat
from autovfx_tpu_torch.utils import png

PREVIEW_SURFELS = 40_000
PREVIEW_CONFIG = RasterConfig(dup_budget=1 << 18)
ENV_HW = (32, 64)


def preview_views(object_path: str, num_views: int = 4, size: int = 256,
                  device=devices.DEFAULT) -> list[tuple[Camera, Gaussians]]:
    """Each preview view's camera and shaded surfel Gaussians on
    ``device``: cameras 1.8 units out and 0.6 up, evenly around the
    asset, looking at its center."""
    device = devices.resolve(device)
    mesh = mesh_io.load_mesh(object_path).normalized_to_unit_box()
    surf = meshsplat.sample_mesh_surfels(
        mesh.vertices, mesh.faces, num_samples=PREVIEW_SURFELS,
        vertex_colors=mesh.vertex_colors, uv=mesh.uv, texture=mesh.texture,
        device=device)
    env_np = np.full(ENV_HW + (3,), 1.0, np.float32)
    env = torch.tensor(env_np, device=device)
    env_sh = torch.tensor(ibl.envmap_sh9(env_np), device=device)
    views = []
    for i in range(num_views):
        a = 2 * np.pi * i / num_views
        cam = look_at_camera([1.8 * np.cos(a), 1.8 * np.sin(a), 0.6],
                             [0, 0, 0], [0, 0, 1], fx=1.2 * size,
                             fy=1.2 * size, width=size, height=size,
                             device=device)
        views.append((cam, meshsplat.shaded_object_gaussians(
            surf, env, env_sh, cam.center)))
    return views


def render_asset_previews(
    object_path: str,
    output_dir: str,
    object_id: str,
    num_views: int = 4,
    size: int = 256,
    device=devices.DEFAULT,
) -> str:
    """Render (or reuse, when the folder already holds ``num_views``
    images) the previews; returns ``<output_dir>/<object_id>``."""
    out_dir = os.path.join(output_dir, object_id)
    if os.path.isdir(out_dir) and len(os.listdir(out_dir)) >= num_views:
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    for i, (cam, g) in enumerate(preview_views(object_path, num_views, size,
                                               device)):
        bg = torch.ones(3, device=g.xyz.device)
        out = rasterize(g, cam, bg=bg, config=PREVIEW_CONFIG)
        img = torch.clamp(out.color, 0, 1).cpu().numpy()
        png.write_png(os.path.join(out_dir, f"{i:03d}.png"),
                      (img * 255).astype(np.uint8))
    return out_dir
