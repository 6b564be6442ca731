"""Public Gaussian-splat rasterizer: novel-view render through one camera.

Counterpart of ``autovfx_tpu/ops/rasterize.py:28-200, 341-390``.  The
pipeline is

  preprocess (kernel 1) -> bin_splats (cumsum, kernel 2, one stable
  sort, tile ranges) -> blend (kernel 3, features read by gid)

with every stage dispatched on the tensors' device: CUDA tensors go
through the hand-written kernels, CPU tensors through their plain
PyTorch versions.  There is no backend switch.

When any input needs a gradient, preprocess and blend go through
``preprocess_cuda.PreprocessFn`` and ``blend_cuda.BlendFn``, whose
backwards are ``csrc/preprocess_bwd.cu`` and kernel 4
(``csrc/blend_bwd.cu``); the binning is integer work and is not
differentiated.  Otherwise the novel-view path runs as it is.

Not ported from the JAX package: ``packed_rows``, ``rasterize_rows``
and ``rasterize_rows_multi`` (the TPU's field-major scene-rows entry
points; a merged render over several ``Gaussians`` sets takes their
place with the edited-frame slice).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from autovfx_tpu_torch.core.cameras import Camera
from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS, Gaussians
from autovfx_tpu_torch.ops import binning, blend_cuda, preprocess_cuda


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """``dup_budget`` is the fixed duplicate allocation of one view (see
    ``binning.BinnedSplats`` for what happens past it); ``tile`` is the
    tile edge in pixels (16 as in CUDA, 32 for fewer duplicates).

    The JAX config's ``chunk``, ``feature_pack`` and ``backend`` are not
    here: the first two are TPU layout knobs (DMA chunk size, bf16 pair
    packing for the gather), and the device of the tensors picks the
    path."""

    dup_budget: int = 1 << 20
    scaling_modifier: float = 1.0
    sh_degree: Optional[int] = None
    tile: int = 16


class RenderOutput(NamedTuple):
    color: torch.Tensor  # (H, W, 3), includes (1 - alpha)·bg
    depth: torch.Tensor  # (H, W) alpha-weighted view-space depth
    alpha: torch.Tensor  # (H, W) 1 - final transmittance
    radii: torch.Tensor  # (N,) int32 screen radius; 0 = culled
    overflow: torch.Tensor  # () bool, duplicate budget exceeded


def rasterize(
    g: Gaussians,
    cam: Camera,
    bg: Optional[torch.Tensor] = None,
    config: RasterConfig = RasterConfig(),
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render Gaussians through one camera.

    ``override_color`` (N, 3) replaces the SH colors.  ``mean2d_offset``
    (N, 2) is added to the screen positions; passed as zeros that need a
    gradient, its gradient is the screen-space position gradient that
    densification reads.
    """
    inputs = [getattr(g, f) for f in PARAM_FIELDS]
    inputs += [t for t in (override_color, mean2d_offset) if t is not None]
    differentiable = torch.is_grad_enabled() and any(
        t.requires_grad for t in inputs)
    pre, blend = ((preprocess_cuda.preprocess_differentiable,
                   blend_cuda.blend_differentiable) if differentiable else
                  (preprocess_cuda.preprocess, blend_cuda.blend))
    splats = pre(
        g, cam, scaling_modifier=config.scaling_modifier,
        override_color=override_color, sh_degree=config.sh_degree,
        tile=config.tile, mean2d_offset=mean2d_offset,
    )
    binned = binning.bin_splats(
        splats, cam.width, cam.height, config.dup_budget, tile=config.tile
    )
    color, depth, alpha = blend(
        binned, splats, cam.width, cam.height, config.tile
    )
    if bg is not None:
        color = color + (1.0 - alpha)[..., None] * bg
    return RenderOutput(
        color=color, depth=depth, alpha=alpha, radii=splats.radius,
        overflow=binned.overflow,
    )


class RenderDict(NamedTuple):
    """RGBA + depth + normal bundle (``gaussian_renderer.render`` parity)."""

    rgba: torch.Tensor  # (H, W, 4)
    depth: torch.Tensor  # (H, W)
    normal: torch.Tensor  # (H, W, 3) normalized
    radii: torch.Tensor  # (N,)
    overflow: torch.Tensor


def render(
    g: Gaussians,
    cam: Camera,
    bg: Optional[torch.Tensor] = None,
    config: RasterConfig = RasterConfig(),
    with_normal: bool = True,
) -> RenderDict:
    """RGBA + depth + normal render.  The normal image is a second pass
    with per-Gaussian normals (min-scale axis, facing the viewer) as
    colors."""
    out = rasterize(g, cam, bg=bg, config=config)
    rgba = torch.cat([out.color, out.alpha[..., None]], dim=-1)
    if with_normal:
        dirs = g.xyz - cam.center[None, :]
        dirs = dirs / torch.clamp(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12
        )
        normals01 = g.normals(view_dirs=dirs) * 0.5 + 0.5
        n_out = rasterize(g, cam, config=config, override_color=normals01)
        normal = (n_out.color - 0.5) * 2.0
        normal = normal / torch.clamp(
            torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-12
        )
    else:
        normal = torch.zeros_like(out.color)
    return RenderDict(
        rgba=rgba, depth=out.depth, normal=normal, radii=out.radii,
        overflow=out.overflow,
    )
