"""Perception-model wrappers, the mask side: DEVA instance masks and the
DiffusionLight envmap, consumed as precomputed files.

Counterpart of ``autovfx_tpu/perception/wrappers.py``.  The external
perception nets are not part of the package; each wrapper keeps the
reference's call signature and output layout and looks for the
precomputed artefacts:

- run_deva: <out_dir>/<object_name_underscored>/<instance_id>/<frame>.png
  binary masks (read with ``utils.png``, no image library);
- get_envmap_from_single_view: <output_dir>/envmap_cam.npy (or .exr /
  .hdr), rotated into the world frame.

The inpainting wrappers (``inpaint_img_with_lama``, ``inpaint_img``,
``fill_img_with_sd``) belong to object removal, slice 7b of ROADMAP.md's
queue 1, and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import glob
import os
import shutil
from typing import List, Optional

import numpy as np

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


def _slice_7b(name: str, reference: str):
    raise NotImplementedError(
        f"{name} is object removal's inpainting, slice 7b of ROADMAP.md's "
        f"queue 1, not ported yet (the JAX package's {reference})")


def inpaint_img_with_lama(
    img: np.ndarray, mask: np.ndarray, *, cache_path: Optional[str] = None,
    ckpt_path: Optional[str] = None,
) -> np.ndarray:
    """LaMa inpainting: slice 7b."""
    _slice_7b("inpaint_img_with_lama",
              "autovfx_tpu/perception/wrappers.py:166")


def inpaint_img(
    img_path: str,
    text_prompt: str = "",
    dilate_kernel_size: int = 10,
    erode_kernel_size: int = 0,
    alpha_threshold: float = 0.7,
) -> str:
    """Alpha-mask panorama inpaint: slice 7b."""
    _slice_7b("inpaint_img", "autovfx_tpu/perception/wrappers.py:198")


def fill_img_with_sd(
    img: np.ndarray,
    mask: np.ndarray,
    text_prompt: str,
    cache_path: Optional[str] = None,
) -> np.ndarray:
    """Stable-Diffusion inpainting: slice 7b."""
    _slice_7b("fill_img_with_sd", "autovfx_tpu/perception/wrappers.py:234")


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
