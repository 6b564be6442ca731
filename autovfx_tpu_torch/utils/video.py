"""Video and trajectory output: frames to a video, and a trajectory's
renders.

Counterpart of ``autovfx_tpu/utils/video.py`` (the reference's
``blend_all.generate_video_from_frames``, 15 fps, and
``sugar/gaussian_splatting/render.py:33-51``'s trajectory renders with
depth and normal dumps).  PNGs are written with ``utils.png``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.utils import png


def _frames_dir(frames: np.ndarray, d: str) -> None:
    os.makedirs(d, exist_ok=True)
    for i, fr in enumerate(frames):
        png.write_png(os.path.join(d, f"{i:04d}.png"), fr)


def write_video(frames: np.ndarray, path: str, fps: int = 15) -> None:
    """(F, H, W, 3) float in [0, 1] or uint8 -> a video at ``path`` with
    imageio (and its ffmpeg backend); without them, a directory of PNGs
    ``<path>.frames/NNNN.png``, as the reference falls back."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio
    except ImportError:
        _frames_dir(frames, path + ".frames")
        return
    try:
        writer = imageio.get_writer(path, fps=fps)
    except ValueError:  # no backend that writes this format (no ffmpeg)
        _frames_dir(frames, path + ".frames")
        return
    with writer:
        for fr in frames:
            writer.append_data(fr)


def _host_uint8(x: torch.Tensor) -> np.ndarray:
    return (np.clip(x.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def render_trajectory(
    gaussians,
    cams,
    out_dir: str,
    config=None,
    save_depth: bool = True,
    save_normal: bool = False,
    video_path: Optional[str] = None,
    fps: int = 15,
    device=devices.DEFAULT,
) -> np.ndarray:
    """Render every camera of the batch ``cams`` through
    ``ops.rasterize.render`` on ``device`` (the splats and cameras are
    moved there); save ``images/NNNNN.png`` (+ ``depth/NNNNN.npy`` and
    ``images/normal_NNNNN.png``) under ``out_dir`` and optionally a
    video.  Returns the (F, H, W, 3) float32 frames clipped to [0, 1]."""
    from autovfx_tpu_torch.core import cameras as C
    from autovfx_tpu_torch.ops.rasterize import RasterConfig, render

    device = devices.resolve(device)
    move = lambda obj: dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))})
    gaussians, cams = move(gaussians), move(cams)
    config = config or RasterConfig()
    img_dir = os.path.join(out_dir, "images")
    depth_dir = os.path.join(out_dir, "depth")
    os.makedirs(img_dir, exist_ok=True)
    if save_depth:
        os.makedirs(depth_dir, exist_ok=True)
    frames = []
    for i in range(C.num_cameras(cams)):
        out = render(gaussians, C.index_camera(cams, i), config=config,
                     with_normal=save_normal)
        rgb = torch.clamp(out.rgba[..., :3], 0, 1)
        frames.append(rgb.cpu().numpy())
        png.write_png(os.path.join(img_dir, f"{i:05d}.png"), _host_uint8(rgb))
        if save_depth:
            np.save(os.path.join(depth_dir, f"{i:05d}.npy"),
                    out.depth.cpu().numpy())
        if save_normal:
            png.write_png(os.path.join(img_dir, f"normal_{i:05d}.png"),
                          _host_uint8(out.normal * 0.5 + 0.5))
    frames = np.stack(frames)
    if video_path:
        write_video(frames, video_path, fps=fps)
    return frames
