"""Perception-model wrappers: DEVA instance masks, the inpainters and the
DiffusionLight envmap.

Counterpart of ``autovfx_tpu/perception/wrappers.py``.  The external
perception nets are not part of the package; each wrapper keeps the
reference's call signature and output layout and looks for the
precomputed artefacts:

- run_deva: <out_dir>/<object_name_underscored>/<instance_id>/<frame>.png
  binary masks (read with ``utils.png``, no image library);
- inpaint_img_with_lama: (H, W, 3) uint8 inpainted image, from a cached
  PNG, the port's big-lama network (``perception.lama``) or OpenCV's
  TELEA inpaint, in that order;
- get_envmap_from_single_view: <output_dir>/envmap_cam.npy (or .exr /
  .hdr), rotated into the world frame.

Images are read and written with ``utils.png``: the machine with the card
has no image library.
"""
from __future__ import annotations

import glob
import importlib.util
import os
import shutil
from typing import List, Optional

import numpy as np

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.utils import png


class PrecomputedInputMissing(RuntimeError):
    """Raised when a perception artefact is neither precomputed nor
    computable in this environment."""


def run_deva(
    img_dir: str,
    output_dir: str,
    prompt: str,
    threshold: float = 0.45,
) -> str:
    """Text-prompted video instance segmentation (DEVA + GroundingDINO +
    SAM): the precomputed masks under ``output_dir/<prompt_underscored>``;
    raises with guidance otherwise (the trackers' checkpoints are
    external)."""
    tag = "_".join(prompt.split(" "))
    out = os.path.join(output_dir, tag)
    if os.path.isdir(out) and any(x.isdigit() for x in os.listdir(out)):
        return out
    raise PrecomputedInputMissing(
        f"DEVA tracking results for '{prompt}' not found at {out}. "
        "Run the DEVA+GroundedSAM tracker offline and place per-instance "
        f"mask folders under {out}/<instance_id>/<frame>.png."
    )


def _frames(instance_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(instance_dir, "*.png")))


def load_instance_masks(tracking_dir: str, instance_id: int) -> np.ndarray:
    """(F, H, W) bool masks for one tracked instance, frames in file-name
    order."""
    frame_files = _frames(os.path.join(tracking_dir, str(instance_id)))
    if not frame_files:
        raise PrecomputedInputMissing(
            f"no masks for instance {instance_id} in {tracking_dir}"
        )
    return np.stack([png.read_mask(f) for f in frame_files])


def _mask_bbox(mask: np.ndarray):
    ys, xs = np.where(mask)
    if len(ys) == 0:
        return None
    return xs.min(), ys.min(), xs.max(), ys.max()


def _bboxes_overlap(a, b) -> bool:
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    return not (ax1 < bx0 or bx1 < ax0 or ay1 < by0 or by1 < ay0)


def _instances_overlap(dir_a: str, dir_b: str, overlap_ratio: float) -> bool:
    """Bounding boxes overlap on >= ``overlap_ratio`` of the co-visible
    frames."""
    frames_a = {os.path.basename(f) for f in _frames(dir_a)}
    frames_b = {os.path.basename(f) for f in _frames(dir_b)}
    both = sorted(frames_a & frames_b)
    if not both:
        return False
    hits = 0
    for name in both:
        ba = _mask_bbox(png.read_mask(os.path.join(dir_a, name)))
        bb = _mask_bbox(png.read_mask(os.path.join(dir_b, name)))
        if ba is None or bb is None:
            continue
        if _bboxes_overlap(ba, bb):
            hits += 1
    return hits / len(both) >= overlap_ratio


def merge_instances(tracking_dir: str, overlap_ratio: float = 0.7) -> List[int]:
    """Greedy instance merge by co-visible bounding-box overlap.

    Two instances whose mask boxes overlap in >= 70 % of their
    co-visible frames are one object split by the detector; their masks
    are unioned into a new instance folder named ``id_a + id_b`` and the
    parents removed.  Returns the surviving ids."""
    ids = sorted(int(x) for x in os.listdir(tracking_dir) if x.isdigit())
    changed = True
    while changed:
        changed = False
        for i in range(len(ids)):
            for j in range(i + 1, len(ids)):
                a, b = ids[i], ids[j]
                dir_a = os.path.join(tracking_dir, str(a))
                dir_b = os.path.join(tracking_dir, str(b))
                if not _instances_overlap(dir_a, dir_b, overlap_ratio):
                    continue
                new_id = a + b
                dir_new = os.path.join(tracking_dir, str(new_id))
                os.makedirs(dir_new, exist_ok=True)
                names = {os.path.basename(f)
                         for d in (dir_a, dir_b) for f in _frames(d)}
                for name in sorted(names):
                    acc = None
                    for d in (dir_a, dir_b):
                        p = os.path.join(d, name)
                        if not os.path.exists(p):
                            continue
                        m = png.read_mask(p)
                        acc = m if acc is None else (acc | m)
                    png.write_png(os.path.join(dir_new, name),
                                  acc.astype(np.uint8) * 255)
                shutil.rmtree(dir_a)
                shutil.rmtree(dir_b)
                ids = [x for x in ids if x not in (a, b)] + [new_id]
                changed = True
                break
            if changed:
                break
    return sorted(ids)


def _read_rgb(path: str) -> np.ndarray:
    """A PNG as (H, W, 3) uint8 RGB (greyscale spread, alpha dropped)."""
    img = png.read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 2:  # greyscale + alpha
        return np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3]


def _read_rgba(path: str) -> np.ndarray:
    """A PNG as (H, W, 4) uint8 RGBA (opaque where it has no alpha)."""
    img = png.read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):  # greyscale [+ alpha]
        grey = np.repeat(img[..., :1], 3, axis=2)
        alpha = img[..., 1:] if img.shape[2] == 2 else None
        img = grey if alpha is None else np.concatenate([grey, alpha], 2)
    if img.shape[2] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=2)
    return img


def inpaint_img_with_lama(
    img: np.ndarray, mask: np.ndarray, *, cache_path: Optional[str] = None,
    ckpt_path: Optional[str] = None, device=devices.DEFAULT,
) -> np.ndarray:
    """LaMa inpainting: (H, W, 3) uint8 or [0, 1] float image and an
    (H, W) mask (nonzero is the hole) -> (H, W, 3) uint8.

    Resolution order, the reference's: a precomputed result at
    ``cache_path``; the big-lama network (``perception.lama``) on
    ``device`` when a checkpoint resolves (``ckpt_path``,
    ``$AUTOVFX_LAMA_CKPT`` or ``~/.cache/autovfx/big-lama``); OpenCV's
    TELEA inpaint when ``cv2`` imports; otherwise an error.  LaMa, once
    a checkpoint resolves, never gives way to TELEA."""
    if cache_path and os.path.exists(cache_path):
        return _read_rgb(cache_path)
    from autovfx_tpu_torch.perception import lama

    out = lama.try_inpaint(img, mask, ckpt_path=ckpt_path, device=device)
    if out is not None:
        return out
    try:
        import cv2
    except ImportError as e:
        raise PrecomputedInputMissing(
            "no LaMa checkpoint (set $AUTOVFX_LAMA_CKPT to a big-lama "
            "checkpoint or directory) and no OpenCV (cv2) for the TELEA "
            "inpaint") from e
    img8 = (img if img.dtype == np.uint8
            else np.clip(img * 255, 0, 255).astype(np.uint8))
    m8 = (np.asarray(mask) > 0).astype(np.uint8) * 255
    return cv2.inpaint(img8, m8, 7, cv2.INPAINT_TELEA)


def inpaint_img(
    img_path: str,
    text_prompt: str = "",
    dilate_kernel_size: int = 10,
    erode_kernel_size: int = 0,
    alpha_threshold: float = 0.7,
    device=devices.DEFAULT,
) -> str:
    """Alpha-mask panorama inpaint: the pixels whose alpha falls below
    ``alpha_threshold`` form the hole, eroded and dilated (square
    structuring elements) against edge fringing, and the RGB is
    inpainted (``inpaint_img_with_lama``).  Writes ``<img>_mask.png`` and
    ``<img>_inpaint.png`` and returns the inpainted path, the
    reference's file contract."""
    from scipy import ndimage

    rgba = _read_rgba(img_path)
    mask = rgba[..., 3] < alpha_threshold * 255
    if erode_kernel_size:
        mask = ndimage.binary_erosion(
            mask, np.ones((erode_kernel_size,) * 2, bool))
    if dilate_kernel_size:
        mask = ndimage.binary_dilation(
            mask, np.ones((dilate_kernel_size,) * 2, bool))
    mask8 = mask.astype(np.uint8) * 255
    base = img_path[:-4]
    png.write_png(base + "_mask.png", mask8)
    out = inpaint_img_with_lama(rgba[..., :3], mask8, device=device)
    out_path = base + "_inpaint.png"
    png.write_png(out_path, np.asarray(out, np.uint8))
    return out_path


def fill_img_with_sd(
    img: np.ndarray,
    mask: np.ndarray,
    text_prompt: str,
    cache_path: Optional[str] = None,
    device=devices.DEFAULT,
) -> np.ndarray:
    """Stable-Diffusion inpainting, an external network: a precomputed
    result at ``cache_path`` first; the diffusers pipeline when
    downloads are opted in (``AUTOVFX_ALLOW_HUB_DOWNLOAD=1``) and it
    imports; else ``inpaint_img_with_lama``, with the same contract."""
    if cache_path and os.path.exists(cache_path):
        return _read_rgb(cache_path)
    if (os.environ.get("AUTOVFX_ALLOW_HUB_DOWNLOAD") == "1"
            and importlib.util.find_spec("diffusers") is not None):
        import torch
        from diffusers import AutoPipelineForInpainting
        from PIL import Image

        pipe = AutoPipelineForInpainting.from_pretrained(
            "diffusers/stable-diffusion-xl-1.0-inpainting-0.1",
            torch_dtype=torch.float32).to(devices.resolve(device))
        out = pipe(
            prompt=text_prompt or "Fill the missing part.",
            image=Image.fromarray(np.asarray(img, np.uint8)),
            mask_image=Image.fromarray(
                (np.asarray(mask) > 0).astype(np.uint8) * 255),
        ).images[0]
        return np.asarray(out)
    return inpaint_img_with_lama(np.asarray(img), np.asarray(mask),
                                 device=device)


def get_envmap_from_single_view(
    img: np.ndarray, output_dir: str, c2w: np.ndarray
) -> str:
    """DiffusionLight chrome-ball HDR estimation: SDXL inference is
    external, so this consumes a precomputed camera-frame equirect at
    <output_dir>/envmap_cam.npy (or .exr / .hdr), rotates it into the
    world frame (on the CPU), writes envmap_world.npy and returns its
    path."""
    import torch

    from autovfx_tpu_torch.render.envmap import (
        load_envmap,
        rotate_envmap_cam_to_world,
    )

    out_path = os.path.join(output_dir, "envmap_world.npy")
    if os.path.exists(out_path):
        return out_path
    for cand in ("envmap_cam.npy", "envmap_cam.exr", "envmap_cam.hdr"):
        p = os.path.join(output_dir, cand)
        if os.path.exists(p):
            env_world = rotate_envmap_cam_to_world(
                torch.tensor(load_envmap(p)),
                torch.tensor(np.asarray(c2w, np.float32)))
            np.save(out_path, env_world.numpy())
            return out_path
    raise PrecomputedInputMissing(
        f"DiffusionLight envmap not found in {output_dir}; run the "
        "DiffusionLight pipeline offline and place envmap_cam.npy there."
    )
