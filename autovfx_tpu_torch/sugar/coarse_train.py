"""Coarse SuGaR training: the 3DGS loss plus entropy and the SDF/density
regularization.

Counterpart of ``autovfx_tpu/sugar/coarse_train.py`` (itself
``sugar_trainers/coarse_density.py:18-889``): the photometric loss, the
opacity entropy, and from ``regularize_from`` on the near-surface
density (or SDF) and normal terms on ``n_sdf_samples`` samples a step;
low-opacity slots are pruned at ``regularize_from``, and densification
runs before it.

A step renders twice, as the reference's does: ``trainer.compute_loss``
with the screen-position offset whose gradient the densify statistics
read, and a second ``rasterize`` for the depth and alpha the SuGaR terms
read.  The second render feeds nothing on a plain step (XLA drops it
under ``jit``), so it is skipped there: a plain step runs kernels 1-4
once, a regularized one twice.

As in the JAX package, ``neighbor_reset_interval`` and ``entropy_until``
are not read: the k-NN lists are rebuilt over every slot on each
regularized step, and the entropy term never stops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from autovfx_tpu_torch.core.cameras import Camera, index_camera
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.ops.rasterize import rasterize
from autovfx_tpu_torch.sugar import density as D
from autovfx_tpu_torch.sugar import regularization as REG
from autovfx_tpu_torch.train import trainer as T
from autovfx_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class SugarConfig:
    base: T.TrainConfig = T.TrainConfig()
    entropy_weight: float = 0.1
    sdf_weight: float = 1.0
    normal_weight: float = 0.1
    sdf_mode: str = "density"  # 'density' | 'sdf'
    regularize_from: int = 9000
    entropy_until: int = 9000
    # 1M samples a step, as the reference (coarse_density.py:166)
    n_sdf_samples: int = 1_000_000
    neighbor_reset_interval: int = 500
    prune_opacity_at_reg_start: float = 0.5


def sugar_losses(
    g: Gaussians,
    cam: Camera,
    out_depth: Optional[torch.Tensor],
    out_alpha: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    cfg: SugarConfig,
    regularize: bool,
    draws: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
):
    """The SuGaR terms of one step (0.0 when there are none); ``draws``
    are the regularized step's sample draws ``(idx, eps)``."""
    loss = 0.0
    if cfg.entropy_weight:
        loss = loss + cfg.entropy_weight * REG.opacity_entropy_loss(g)
    if regularize and cfg.sdf_weight:
        with trace.span("sugar.density"):
            samples = REG.sample_sdf_points(g, generator, cfg.n_sdf_samples,
                                            draws=draws)
            # one evaluation of the field serves both terms
            field = D.density_field(samples.points, samples.neighbors, g)
            term = (REG.sdf_regularization_loss if cfg.sdf_mode == "sdf"
                    else REG.density_regularization_loss)
            loss = loss + cfg.sdf_weight * term(g, samples, cam, out_depth,
                                                out_alpha, field)
            if cfg.normal_weight:
                loss = loss + cfg.normal_weight * (
                    REG.normal_consistency_loss(g, samples, field))
    return loss


def coarse_loss(
    g: Gaussians,
    mean2d_offset: torch.Tensor,
    cam: Camera,
    image: torch.Tensor,
    cfg: SugarConfig,
    regularize: bool,
    generator: Optional[torch.Generator],
    draws: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
):
    """A coarse step's loss and ``(radii, overflow, psnr)``: the 3DGS
    loss of the first render, and the SuGaR terms on the second render's
    depth and alpha (rendered only when they read it)."""
    loss, aux = T.compute_loss(g, mean2d_offset, cam, image, cfg.base)
    depth = alpha = None
    if regularize and cfg.sdf_weight:
        out = rasterize(g, cam, config=cfg.base.raster)
        depth, alpha = out.depth, out.alpha
    return loss + sugar_losses(g, cam, depth, alpha, generator, cfg,
                               regularize, draws), aux


def coarse_step(
    state: T.TrainState,
    cam: Camera,
    image: torch.Tensor,
    cfg: SugarConfig,
    regularize: bool,
    generator: Optional[torch.Generator],
    draws: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> tuple[T.TrainState, T.StepAux]:
    """One coarse step: its renders, losses, backward, Adam and densify
    statistics (the state's tensors are updated in place)."""
    return T.step_with_loss(state, cam, cfg.base, lambda g, offset: coarse_loss(
        g, offset, cam, image, cfg, regularize, generator, draws))


def coarse_train(
    g: Gaussians,
    cams: Camera,
    images: torch.Tensor,
    cfg: SugarConfig,
    generator: Optional[torch.Generator] = None,
    log_every: int = 0,
    cam_indices: Optional[Sequence[int]] = None,
    sdf_draws: Optional[Sequence[tuple[torch.Tensor, torch.Tensor]]] = None,
):
    """The host loop over ``cfg.base.iterations`` coarse steps.  Returns
    (state, history).

    Cameras and samples are drawn from ``generator`` (default: seed 0 on
    the Gaussians' device); ``cam_indices`` gives the camera of every
    step instead, and ``sdf_draws`` the ``(idx, eps)`` of every
    regularized step, in order."""
    if generator is None:
        generator = torch.Generator(device=g.xyz.device).manual_seed(0)
    state = T.init_state(g)
    n_cams = images.shape[0]
    base = cfg.base
    history = []
    n_reg = 0
    for it in range(1, base.iterations + 1):
        if cam_indices is None:
            ci = int(torch.randint(n_cams, (), generator=generator,
                                   device=generator.device))
        else:
            ci = int(cam_indices[it - 1])
        regularize = it >= cfg.regularize_from
        draws = None
        if regularize and sdf_draws is not None:
            draws = sdf_draws[n_reg]
        n_reg += regularize
        state, aux = coarse_step(state, index_camera(cams, ci), images[ci],
                                 cfg, regularize, generator, draws)
        if it == cfg.regularize_from:
            # prune low-opacity Gaussians as regularization starts
            g_cur = state.gaussians
            keep = g_cur.opacity >= cfg.prune_opacity_at_reg_start
            state = dataclasses.replace(state, gaussians=dataclasses.replace(
                g_cur, active=g_cur.active & keep))
        if (base.densify_from_iter < it < base.densify_until_iter
                and it % base.densification_interval == 0
                and not regularize):
            # densify_step zeroes the Adam moments of the slots it rewrites
            state, _ = T.densify_step(state, generator, base, it)
        if log_every and it % log_every == 0:
            history.append({"iter": it, "loss": float(aux.loss),
                            "psnr": float(aux.psnr)})
    return state, history
