"""Kernel 3 and kernel 4 wrappers: the tile blend (``csrc/blend_fwd.cu``)
and its backward (``csrc/blend_bwd.cu``).

A CUDA tensor goes through the kernels, or the call raises; a CPU tensor
goes through the plain versions ``blend_ref.blend_tiles_ref`` and
``blend_ref.blend_tiles_ref_bwd`` over every tile.

The images are in the JAX package's layout, color (H, W, 3), depth
(H, W), alpha (H, W), without the background term.  ``blend`` is the
novel-view entry; ``BlendFn`` is the differentiable one, whose forward
is kernel 3's training variant (it also keeps each pixel's final
transmittance and last contributor for kernel 4).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from autovfx_tpu_torch.ops import _build, blend_ref
from autovfx_tpu_torch.ops._build import check_tensor
from autovfx_tpu_torch.ops.binning import BinnedSplats
from autovfx_tpu_torch.ops.blend_ref import SplatGrads
from autovfx_tpu_torch.ops.projection import Splats2D
from autovfx_tpu_torch.utils import trace

TILES = (16, 32)  # tile edges the kernels are instantiated for
GRAD_FIELDS = 10  # kernel 4's per-Gaussian row: mean2d 2, conic 3, op, rgb, d


class BlendState(NamedTuple):
    """What kernel 3's training variant keeps for kernel 4, per pixel."""

    final_t: torch.Tensor  # (H, W) f32 transmittance after the last blend
    n_contrib: torch.Tensor  # (H, W) int32 duplicates of the tile up to it


def blend(
    binned: BinnedSplats, splats: Splats2D, width: int, height: int,
    tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Front-to-back blend of a binned view: ``(color, depth, alpha)``."""
    if not binned.gid.is_cuda:
        tiles = blend_ref.blend_tiles_ref(binned, splats, tile)
        tx, ty = binned.num_tiles_x, binned.num_tiles_y
        return tuple(
            blend_ref.assemble_image(x, tx, ty, width, height, tile)
            for x in tiles
        )
    return blend_kernel(binned, splats, width, height, tile)


def _check_inputs(binned: BinnedSplats, splats: Splats2D, width: int,
                  height: int, tile: int) -> int:
    """Raise unless the kernels take these; returns the tile count."""
    if tile not in TILES:
        raise ValueError(f"the blend kernel supports tiles {TILES}, got {tile}")
    tx, ty = binned.num_tiles_x, binned.num_tiles_y
    if (tx, ty) != ((width + tile - 1) // tile, (height + tile - 1) // tile):
        raise ValueError("binned tile grid does not match the image size")
    n_tiles = tx * ty
    n = splats.depth.shape[0]
    f32 = torch.float32
    check_tensor(binned.tile_range, "tile_range", torch.int32, (n_tiles, 2))
    check_tensor(binned.gid, "gid", torch.int32, tuple(binned.gid.shape))
    check_tensor(splats.mean2d, "mean2d", f32, (n, 2))
    check_tensor(splats.conic, "conic", f32, (n, 3))
    check_tensor(splats.opacity, "opacity", f32, (n,))
    check_tensor(splats.color, "color", f32, (n, 3))
    check_tensor(splats.depth, "depth", f32, (n,))
    return n_tiles


def _feature_ptrs(binned: BinnedSplats, splats: Splats2D) -> tuple:
    return (binned.tile_range.data_ptr(), binned.gid.data_ptr(),
            splats.mean2d.data_ptr(), splats.conic.data_ptr(),
            splats.opacity.data_ptr(), splats.color.data_ptr(),
            splats.depth.data_ptr())


def _images(width: int, height: int, dev):
    f32 = torch.float32
    return (torch.empty((height, width, 3), dtype=f32, device=dev),
            torch.empty((height, width), dtype=f32, device=dev),
            torch.empty((height, width), dtype=f32, device=dev))


def blend_kernel(
    binned: BinnedSplats, splats: Splats2D, width: int, height: int,
    tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n_tiles = _check_inputs(binned, splats, width, height, tile)
    dev = binned.gid.device
    color, depth, alpha = _images(width, height, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.blend_fwd(
            *_feature_ptrs(binned, splats), n_tiles, binned.num_tiles_x,
            tile, width, height,
            color.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "blend_fwd")
    trace.count("launch.blend_fwd")
    return color, depth, alpha


def blend_train_kernel(
    binned: BinnedSplats, splats: Splats2D, width: int, height: int,
    tile: int,
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], BlendState]:
    """Kernel 3's training variant: the images and the ``BlendState``."""
    n_tiles = _check_inputs(binned, splats, width, height, tile)
    dev = binned.gid.device
    color, depth, alpha = _images(width, height, dev)
    state = BlendState(
        final_t=torch.empty((height, width), dtype=torch.float32, device=dev),
        n_contrib=torch.empty((height, width), dtype=torch.int32, device=dev),
    )
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.blend_fwd_train(
            *_feature_ptrs(binned, splats), n_tiles, binned.num_tiles_x,
            tile, width, height,
            color.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
            state.final_t.data_ptr(), state.n_contrib.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "blend_fwd_train")
    trace.count("launch.blend_fwd_train")
    return (color, depth, alpha), state


# ---- backward ------------------------------------------------------------


def blend_bwd_kernel(
    binned: BinnedSplats, splats: Splats2D, state: BlendState,
    g_color: torch.Tensor, g_depth: torch.Tensor, g_alpha: torch.Tensor,
    width: int, height: int, tile: int,
) -> SplatGrads:
    """Kernel 4: per-Gaussian gradients from the images' gradients and
    the forward's ``state`` (``blend_train_kernel``)."""
    n_tiles = _check_inputs(binned, splats, width, height, tile)
    f32 = torch.float32
    check_tensor(state.final_t, "final_t", f32, (height, width))
    check_tensor(state.n_contrib, "n_contrib", torch.int32, (height, width))
    check_tensor(g_color, "g_color", f32, (height, width, 3))
    check_tensor(g_depth, "g_depth", f32, (height, width))
    check_tensor(g_alpha, "g_alpha", f32, (height, width))
    n = splats.depth.shape[0]
    grad = torch.zeros((n, GRAD_FIELDS), dtype=f32, device=g_color.device)
    lib = _build.load_library()
    with torch.cuda.device(g_color.device):
        err = lib.blend_bwd(
            *_feature_ptrs(binned, splats), state.final_t.data_ptr(),
            state.n_contrib.data_ptr(), g_color.data_ptr(),
            g_depth.data_ptr(), g_alpha.data_ptr(), n_tiles,
            binned.num_tiles_x, tile, width, height, grad.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "blend_bwd")
    trace.count("launch.blend_bwd")
    return SplatGrads(mean2d=grad[:, 0:2], conic=grad[:, 2:5],
                      opacity=grad[:, 5], color=grad[:, 6:9],
                      depth=grad[:, 9])


class BlendFn(torch.autograd.Function):
    """Differentiable blend: kernel 3's training variant forward, kernel
    4 backward; on CPU tensors the plain blend and its plain backward.

    ``apply(mean2d, conic, opacity, color, depth, binned, width, height,
    tile)`` returns ``(color, depth, alpha)`` images; the binning is not
    differentiated."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, depth, binned, width,
                height, tile):
        features = (mean2d, conic, opacity, color, depth)
        splats = _feature_splats(*features)
        if binned.gid.is_cuda:
            images, state = blend_train_kernel(binned, splats, width, height,
                                               tile)
            ctx.save_for_backward(*features, *state)
        else:
            images = blend(binned, splats, width, height, tile)
            ctx.save_for_backward(*features)
        ctx.binned, ctx.size = binned, (width, height, tile)
        return images

    @staticmethod
    def backward(ctx, g_color, g_depth, g_alpha):
        binned, (width, height, tile) = ctx.binned, ctx.size
        saved = ctx.saved_tensors
        splats = _feature_splats(*saved[:5])
        g_color, g_depth, g_alpha = (x.contiguous() for x in
                                     (g_color, g_depth, g_alpha))
        if binned.gid.is_cuda:
            d = blend_bwd_kernel(binned, splats, BlendState(*saved[5:]),
                                 g_color, g_depth, g_alpha, width, height,
                                 tile)
        else:
            d = blend_ref.blend_tiles_ref_bwd(binned, splats, g_color,
                                              g_depth, g_alpha, tile)
        return (d.mean2d, d.conic, d.opacity, d.color, d.depth,
                None, None, None, None)


def _feature_splats(mean2d, conic, opacity, color, depth) -> Splats2D:
    """A ``Splats2D`` holding the blend's inputs (the int fields unused)."""
    return Splats2D(mean2d=mean2d, conic=conic, color=color, opacity=opacity,
                    depth=depth, radius=None, tile_min=None, tile_max=None,
                    tiles_touched=None)


def blend_differentiable(
    binned: BinnedSplats, splats: Splats2D, width: int, height: int,
    tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``blend`` through ``BlendFn``."""
    return BlendFn.apply(splats.mean2d, splats.conic, splats.opacity,
                         splats.color, splats.depth, binned, width, height,
                         tile)
