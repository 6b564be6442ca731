"""3DGS training: one step renders, takes every loss, runs the backward
and a per-field Adam, and accumulates the densification stats.

Counterpart of ``autovfx_tpu/train/trainer.py`` (itself
``sugar/gaussian_splatting/train.py`` and
``scene/gaussian_model.py:159-199``): the same ``TrainConfig`` defaults,
the exponential position learning rate, Adam with b1 0.9, b2 0.999 and
eps 1e-15 masked to active slots, densification every
``densification_interval`` steps and an opacity reset every
``opacity_reset_interval``.

The render goes through ``ops.rasterize``; on CUDA tensors its forward
and backward are the hand-written kernels.  The Adam update runs in
place on the parameter and moment tensors under ``torch.no_grad()``, so
a step allocates no second copy of the scene; ``init_state`` copies the
Gaussians it is given, so the caller's stay as they were.  Steps,
learning rates and bias corrections are host numbers, and nothing in a
step waits for the device.  ``torch.optim.Adam`` is not used: it has no
active mask and cannot zero the moments of the slots densification
rewrites.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core.cameras import Camera, index_camera
from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS, Gaussians
from autovfx_tpu_torch.ops.knn import mean_knn_dist2
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.train import losses as L
from autovfx_tpu_torch.train.densify import (
    DensifyResult,
    DensifyStats,
    densify_and_prune,
    reset_opacity,
)
from autovfx_tpu_torch.utils import trace

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # optimization (OptimizationParams)
    iterations: int = 15_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    spatial_lr_scale: float = 5.0
    lambda_dssim: float = 0.2
    # extra regularizers; 0 disables
    lambda_depth: float = 0.0
    lambda_normal: float = 0.0
    lambda_pseudo_normal: float = 0.0
    lambda_alpha: float = 0.0
    lambda_anisotropic: float = 0.0
    scene_scale: float = 5.0
    # densification
    percent_dense: float = 0.01
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    size_threshold: Optional[int] = 20
    raster: RasterConfig = RasterConfig()


def _zeros_like(g: Gaussians) -> Gaussians:
    return Gaussians(**{f.name: torch.zeros_like(getattr(g, f.name))
                        for f in dataclasses.fields(Gaussians)})


@dataclasses.dataclass(frozen=True)
class AdamState:
    """First and second moments, one per parameter field (``active`` is
    carried as zeros, as in the JAX package), and the update count."""

    m: Gaussians
    v: Gaussians
    count: int

    @classmethod
    def zero(cls, g: Gaussians) -> "AdamState":
        return cls(m=_zeros_like(g), v=_zeros_like(g), count=0)


@dataclasses.dataclass(frozen=True)
class TrainState:
    gaussians: Gaussians
    adam: AdamState
    stats: DensifyStats
    step: int


def position_lr(step: int, cfg: TrainConfig) -> float:
    """Exponential log-lerp of the position learning rate, in float32
    as the JAX package computes it."""
    f32 = np.float32
    init = f32(cfg.position_lr_init * cfg.spatial_lr_scale)
    final = f32(max(cfg.position_lr_final * cfg.spatial_lr_scale, 1e-12))
    t = f32(np.clip(f32(step) / f32(cfg.position_lr_max_steps), 0.0, 1.0))
    return float(np.exp(np.log(init) * (f32(1) - t) + np.log(final) * t))


def field_lrs(step: int, cfg: TrainConfig) -> dict:
    return {
        "xyz": position_lr(step, cfg),
        "sh_dc": cfg.feature_lr,
        "sh_rest": cfg.feature_lr / 20.0,
        "log_scales": cfg.scaling_lr,
        "quats": cfg.rotation_lr,
        "opacity_logit": cfg.opacity_lr,
    }


def init_gaussians_from_points(xyz: torch.Tensor, rgb: torch.Tensor,
                               sh_degree: int = 3) -> Gaussians:
    """``create_from_pcd``: isotropic scale sqrt(mean 3-NN squared
    distance), opacity 0.1."""
    d2 = torch.clamp(mean_knn_dist2(xyz), min=1e-7)
    return Gaussians.create(xyz, rgb, sh_degree=sh_degree,
                            initial_scale=torch.sqrt(d2))


def init_state(g: Gaussians) -> TrainState:
    """A fresh state holding copies of ``g``'s tensors (the steps update
    the state's tensors in place)."""
    g = Gaussians(**{f.name: getattr(g, f.name).clone()
                     for f in dataclasses.fields(Gaussians)})
    return TrainState(gaussians=g, adam=AdamState.zero(g),
                      stats=DensifyStats.zero(g.capacity, device=g.xyz.device),
                      step=0)


class StepAux(NamedTuple):
    loss: torch.Tensor  # () f32
    psnr: torch.Tensor  # () f32
    overflow: torch.Tensor  # () bool, the view's duplicate budget overflowed


def compute_loss(
    g: Gaussians,
    mean2d_offset: torch.Tensor,
    cam: Camera,
    gt_rgb: torch.Tensor,
    cfg: TrainConfig,
    gt_depth: Optional[torch.Tensor] = None,
    gt_normal: Optional[torch.Tensor] = None,
):
    """The training loss and ``(radii, overflow, psnr)``."""
    bg = torch.zeros((3,), dtype=torch.float32, device=g.xyz.device)
    out = rasterize(g, cam, bg=bg, config=cfg.raster,
                    mean2d_offset=mean2d_offset)
    with trace.span("step.loss"):
        loss = L.photometric_loss(out.color, gt_rgb, cfg.lambda_dssim)
    if cfg.lambda_depth and gt_depth is not None:
        loss = loss + cfg.lambda_depth * L.depth_loss(
            out.depth, gt_depth, cfg.scene_scale)
    if cfg.lambda_normal and gt_normal is not None:
        # a second pass with the normals as colors
        dirs = g.xyz - cam.center[None, :]
        dirs = dirs / torch.clamp(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
        normals01 = g.normals(view_dirs=dirs) * 0.5 + 0.5
        n_out = rasterize(g, cam, config=cfg.raster, override_color=normals01)
        normal_img = (n_out.color - 0.5) * 2.0
        loss = loss + cfg.lambda_normal * L.normal_loss(
            normal_img, gt_normal, out.depth, cfg.scene_scale)
    if cfg.lambda_pseudo_normal and gt_normal is not None:
        pts = cam.center + cam.ray_directions() * out.depth[..., None]
        loss = loss + cfg.lambda_pseudo_normal * L.normal_loss(
            L.depth_to_normal(pts), gt_normal, out.depth, cfg.scene_scale)
    if cfg.lambda_alpha:
        loss = loss + cfg.lambda_alpha * L.opacity_loss(out.alpha)
    if cfg.lambda_anisotropic:
        loss = loss + cfg.lambda_anisotropic * L.anisotropic_loss(
            g.scales, g.active)
    return loss, (out.radii, out.overflow, L.psnr(out.color, gt_rgb))


def apply_adam(
    g: Gaussians,
    adam: AdamState,
    param_grads: dict,
    step: int,
    cfg: TrainConfig,
) -> tuple[Gaussians, AdamState]:
    """One Adam update of every parameter field, masked to active slots,
    in place on ``g``'s and ``adam``'s tensors (which are returned)."""
    lrs = field_lrs(step, cfg)
    count = adam.count + 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(ADAM_B1) ** f32(count))
    bc2 = float(f32(1) - f32(ADAM_B2) ** f32(count))
    with torch.no_grad():
        for f in PARAM_FIELDS:
            gr = param_grads[f]
            m, v, p = getattr(adam.m, f), getattr(adam.v, f), getattr(g, f)
            m.mul_(ADAM_B1).add_(gr, alpha=1 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(gr, gr, value=1 - ADAM_B2)
            update = lrs[f] * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
            mask = g.active.reshape((-1,) + (1,) * (gr.ndim - 1))
            p.sub_(torch.where(mask, update, torch.zeros_like(update)))
    return g, dataclasses.replace(adam, count=count)


def loss_and_grads(g: Gaussians, loss_fn):
    """``loss_fn(g, mean2d_offset)`` -> (loss, (radii, overflow, psnr)),
    its backward: (loss, (radii, overflow, psnr), the parameter
    gradients by field, the screen-position gradient)."""
    with torch.enable_grad():
        params = {f: getattr(g, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        offset = torch.zeros((g.capacity, 2), dtype=torch.float32,
                             device=g.xyz.device, requires_grad=True)
        loss, aux = loss_fn(dataclasses.replace(g, **params), offset)
        with trace.span("step.backward"):
            grads = torch.autograd.grad(loss, [*params.values(), offset])
    return loss.detach(), aux, dict(zip(PARAM_FIELDS, grads)), grads[-1]


def step_with_loss(state: TrainState, cam: Camera, cfg: TrainConfig,
                   loss_fn) -> tuple[TrainState, StepAux]:
    """One step of ``loss_fn(g, mean2d_offset)`` -> (loss, (radii,
    overflow, psnr)): its backward, Adam and the densify stats.  The
    state's tensors are updated in place; the returned state holds
    them."""
    with trace.span("step"):
        loss, (radii, overflow, psnr), grads, offset_grad = loss_and_grads(
            state.gaussians, loss_fn)
        with trace.span("step.adam"):
            g, adam = apply_adam(state.gaussians, state.adam, grads,
                                 state.step, cfg)
            stats = state.stats.update(offset_grad, radii, cam.width,
                                       cam.height)
        return (TrainState(gaussians=g, adam=adam, stats=stats,
                           step=state.step + 1),
                StepAux(loss=loss, psnr=psnr.detach(), overflow=overflow))


def train_step(
    state: TrainState,
    cam: Camera,
    gt_rgb: torch.Tensor,
    cfg: TrainConfig,
    gt_depth: Optional[torch.Tensor] = None,
    gt_normal: Optional[torch.Tensor] = None,
) -> tuple[TrainState, StepAux]:
    """Render, loss, backward, Adam and stats for one view.  The state's
    tensors are updated in place; the returned state holds them."""
    return step_with_loss(state, cam, cfg, lambda g, offset: compute_loss(
        g, offset, cam, gt_rgb, cfg, gt_depth, gt_normal))


def densify_step(
    state: TrainState,
    generator: Optional[torch.Generator],
    cfg: TrainConfig,
    iteration: int,
    noise: Optional[torch.Tensor] = None,
) -> tuple[TrainState, DensifyResult]:
    """Densify and prune, and zero the Adam moments of every slot it
    rewrote or freed (``cat_tensors_to_optimizer``)."""
    size_thr = (cfg.size_threshold
                if cfg.size_threshold and iteration > cfg.opacity_reset_interval
                else None)
    res = densify_and_prune(
        state.gaussians, state.stats, generator,
        grad_threshold=cfg.densify_grad_threshold,
        min_opacity=cfg.min_opacity, extent=cfg.spatial_lr_scale,
        percent_dense=cfg.percent_dense, max_screen_size=size_thr,
        noise=noise,
    )
    with torch.no_grad():
        for moments in (state.adam.m, state.adam.v):
            for f in PARAM_FIELDS:
                x = getattr(moments, f)
                x.masked_fill_(res.new_mask.reshape((-1,) + (1,) * (x.ndim - 1)),
                               0.0)
    return (dataclasses.replace(state, gaussians=res.gaussians,
                                stats=res.stats), res)


def reset_opacity_step(state: TrainState) -> TrainState:
    """Cap the opacities at 0.01 and zero their Adam moments."""
    with torch.no_grad():
        state.adam.m.opacity_logit.zero_()
        state.adam.v.opacity_logit.zero_()
    return dataclasses.replace(state, gaussians=reset_opacity(state.gaussians))


def train(
    g: Gaussians,
    cams: Camera,
    images: torch.Tensor,
    cfg: TrainConfig,
    generator: Optional[torch.Generator] = None,
    log_every: int = 0,
    depths: Optional[torch.Tensor] = None,
    normals: Optional[torch.Tensor] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
):
    """The host training loop over a stacked ``cams`` batch (F cameras)
    and ``images`` (F, H, W, 3).

    Cameras are drawn, and split noise sampled, from ``generator`` (a CPU
    ``torch.Generator``; seed 0 by default).  ``checkpoint_path`` /
    ``checkpoint_every`` save the whole state periodically and at the end
    (``train.checkpoint``).  Returns the final state and, every
    ``log_every`` steps, the loss, PSNR and active count."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    state = init_state(g)
    n_cams = images.shape[0]
    history = []
    for it in range(1, cfg.iterations + 1):
        ci = int(torch.randint(n_cams, (), generator=generator))
        state, aux = train_step(
            state, index_camera(cams, ci), images[ci], cfg,
            gt_depth=None if depths is None else depths[ci],
            gt_normal=None if normals is None else normals[ci])

        if it < cfg.densify_until_iter:
            if (it > cfg.densify_from_iter
                    and it % cfg.densification_interval == 0):
                state, _ = densify_step(state, generator, cfg, it)
            if it % cfg.opacity_reset_interval == 0:
                state = reset_opacity_step(state)

        if checkpoint_path and checkpoint_every and (
                it % checkpoint_every == 0 or it == cfg.iterations):
            from autovfx_tpu_torch.train.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_path, state)
        if log_every and it % log_every == 0:
            history.append({"iter": it, "loss": float(aux.loss),
                            "psnr": float(aux.psnr),
                            "active": int(state.gaussians.num_active)})
    return state, history
