"""Evaluation: PSNR, SSIM and LPIPS over the eval split.

Counterpart of ``autovfx_tpu/utils/metrics.py``: every 8th frame is
evaluated, rendered through ``ops.rasterize.rasterize`` (kernels 1-3 on
the card), with ``train.losses``' PSNR and SSIM and ``utils.lpips``.
Random-feature LPIPS (no weights file) is a relative metric only, so it
is reported under ``lpips_random_features`` and ``lpips`` stays None:
a consumer reads ``lpips_source`` to know which it has.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.cameras import Camera, index_camera
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.train.losses import psnr as _psnr, ssim as _ssim
from autovfx_tpu_torch.utils import lpips as LP

EVAL_EVERY_NTH = 8


def eval_split(n_frames: int, every_nth: int = EVAL_EVERY_NTH) -> List[int]:
    return list(range(0, n_frames, every_nth))


def lpips_available() -> bool:
    return True  # the package's own LPIPS, always on


def lpips(img1, img2, device=None) -> float:
    """LPIPS(vgg) between two (H, W, 3) images in [0, 1] (arrays or
    tensors), on ``device``: by default the first image's when it is a
    tensor, else the card."""
    if device is None:
        device = img1.device if torch.is_tensor(img1) else devices.DEFAULT
    device = devices.resolve(device)
    t = lambda x: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                  else x, dtype=torch.float32, device=device)
    return float(LP.lpips_distance(t(img1), t(img2)))


def evaluate(
    g: Gaussians,
    cams: Camera,
    gt_images,
    config: RasterConfig = RasterConfig(),
    every_nth: int = EVAL_EVERY_NTH,
    out_json: Optional[str] = None,
) -> Dict:
    """PSNR, SSIM and LPIPS over the eval split of the (F, H, W, 3)
    ground-truth images, rendered on the scene's device; optionally
    written to ``out_json``."""
    dev = g.xyz.device
    idxs = eval_split(len(gt_images), every_nth)
    psnrs, ssims, lp = [], [], []
    for i in idxs:
        img = rasterize(g, index_camera(cams, i), config=config).color
        gt = torch.as_tensor(np.asarray(gt_images[i]) if not torch.is_tensor(
            gt_images[i]) else gt_images[i], dtype=torch.float32, device=dev)
        psnrs.append(float(_psnr(img, gt)))
        ssims.append(float(_ssim(img, gt)))
        if lpips_available():
            lp.append(float(LP.lpips_distance(img, gt)))
    lp_source = LP.get_params(device=dev).source
    lp_mean = float(np.mean(lp)) if lp else None
    result = {
        "num_eval_frames": len(idxs),
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "lpips": lp_mean if lp_source == "file" else None,
        "lpips_random_features": lp_mean if lp_source == "random" else None,
        "lpips_source": lp_source,
        "per_frame_psnr": psnrs,
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result
