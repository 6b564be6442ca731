"""3DGS retraining on inpainted views after object removal.

Counterpart of ``autovfx_tpu/train/inpaint_retrain.py`` (the reference's
``scene_representation.training_3DGS_for_inpainting`` with the loss of
``inpaint/retrain_utils.py``): the removal splats, padded to
max(1.5 x capacity, capacity + 1024) slots, are trained toward the
inpainted views for 2,000 iterations on a black background; the loss is
the photometric loss, a masked L1 over the removal region and, on views
whose hole spans at least 32 px both ways (``is_large_mask``), 0.4 x
LPIPS averaged over the hole (``utils.lpips.lpips_distance(mask=...)``);
densification every 300 iterations from 300 with ``min_opacity`` 0.1,
no opacity reset.  The result is ``inpaint_gaussians.ply``.

Each step is ``trainer.step_with_loss`` of ``inpaint_loss``: the render
and its backward go through kernels 1-4 and the preprocess backward on
the card.  The views are drawn from a CPU ``torch.Generator`` seeded 0,
which also draws the split noise, where the JAX package draws from
``jax.random.PRNGKey(0)``: the two packages visit the views in
different orders.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core import ply_io
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.train import losses as L
from autovfx_tpu_torch.train import trainer as T
from autovfx_tpu_torch.utils import png
from autovfx_tpu_torch.utils.lpips import lpips_distance

LAMBDA_LPIPS = 0.4


def is_large_mask(mask: np.ndarray, min_extent: int = 32) -> bool:
    """LPIPS only where the hole's bounding box spans at least
    ``min_extent`` px in x and in y."""
    ys, xs = np.where(mask)
    if len(ys) == 0:
        return False
    return bool(xs.max() - xs.min() >= min_extent
                and ys.max() - ys.min() >= min_extent)


def inpaint_loss(g, offset, cam, gt_rgb: torch.Tensor, mask: torch.Tensor,
                 cfg: T.TrainConfig, use_lpips: bool,
                 lambda_lpips: float = LAMBDA_LPIPS):
    """The photometric loss + the L1 over ``mask`` (+ ``lambda_lpips`` x
    LPIPS over ``mask``), and ``(radii, overflow, psnr)``."""
    bg = torch.zeros((3,), dtype=torch.float32, device=gt_rgb.device)
    out = rasterize(g, cam, bg=bg, config=cfg.raster, mean2d_offset=offset)
    m = mask.to(torch.float32)[..., None]
    l1 = torch.sum(torch.abs(out.color - gt_rgb) * m) / torch.clamp(
        torch.sum(m) * 3.0, min=1.0)
    loss = L.photometric_loss(out.color, gt_rgb, cfg.lambda_dssim) + l1
    if use_lpips:
        loss = loss + lambda_lpips * lpips_distance(out.color, gt_rgb,
                                                    mask=mask)
    return loss, (out.radii, out.overflow, L.psnr(out.color, gt_rgb))


def inpaint_step(state: T.TrainState, cam, img: torch.Tensor,
                 mask: torch.Tensor, cfg: T.TrainConfig, use_lpips: bool):
    """One retraining step toward the inpainted ``img``: (state, aux)."""
    return T.step_with_loss(state, cam, cfg, lambda g, offset: inpaint_loss(
        g, offset, cam, img, mask, cfg, use_lpips))


def inpaint_config(scene_representation, iterations: int) -> T.TrainConfig:
    """The reference's schedule at the scene's duplicate budget."""
    return T.TrainConfig(
        iterations=iterations,
        raster=RasterConfig(dup_budget=scene_representation.hparams.dup_budget),
        densification_interval=300,
        min_opacity=0.1,
        densify_from_iter=300,
        densify_until_iter=iterations,
        opacity_reset_interval=10**9,
        spatial_lr_scale=scene_representation.scene_scale,
    )


def training_3DGS_for_inpainting(
    scene_representation,
    removal_gaussians_path: str,
    inpainted_dir: str,
    mask_dir: str,
    out_dir: str,
    camera_poses_json: str,
    iterations: int = 2000,
    device=devices.DEFAULT,
) -> str:
    """Retrain the removal splats on the inpainted views (PNGs named by
    ``camera_poses_json``'s frames, their hole masks beside them in
    ``mask_dir``; a view without a mask is all hole) on ``device``;
    returns the path of ``<out_dir>/inpaint_gaussians.ply``."""
    device = devices.resolve(device)
    g = ply_io.load_gaussians(removal_gaussians_path, device=device)
    g = g.pad_to(max(int(1.5 * g.capacity), g.capacity + 1024))

    cams, _, names = C.load_custom_trajectory(camera_poses_json,
                                              device=device)
    imgs, masks, large = [], [], []
    for name in names:
        img = png.read_png(os.path.join(inpainted_dir, name))[..., :3]
        imgs.append(img.astype(np.float32) / 255.0)
        mp = os.path.join(mask_dir, name)
        m = (png.read_mask(mp) if os.path.exists(mp)
             else np.ones(img.shape[:2], bool))
        masks.append(m)
        large.append(is_large_mask(m))
    imgs = torch.tensor(np.stack(imgs), device=device)
    masks = torch.tensor(np.stack(masks), device=device)

    cfg = inpaint_config(scene_representation, iterations)
    state = T.init_state(g)
    generator = torch.Generator().manual_seed(0)
    for it in range(1, iterations + 1):
        ci = int(torch.randint(len(names), (), generator=generator))
        state, _ = inpaint_step(state, C.index_camera(cams, ci), imgs[ci],
                                masks[ci], cfg, large[ci])
        if (cfg.densify_from_iter <= it < cfg.densify_until_iter
                and it % cfg.densification_interval == 0):
            state, _ = T.densify_step(state, generator, cfg, it)

    out_path = os.path.join(out_dir, "inpaint_gaussians.ply")
    os.makedirs(out_dir, exist_ok=True)
    ply_io.save_ply(out_path, state.gaussians)
    return out_path
