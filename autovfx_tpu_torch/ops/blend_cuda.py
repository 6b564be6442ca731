"""Kernel 3 wrapper: the forward tile blend (``csrc/blend_fwd.cu``).

A CUDA tensor goes through the kernel, or the call raises; a CPU tensor
goes through the plain version ``blend_ref.blend_tiles_ref`` over every
tile.  ``launches`` counts kernel launches and nothing else.

Both return the images in the JAX package's layout, color (H, W, 3),
depth (H, W), alpha (H, W), without the background term.
"""
from __future__ import annotations

import torch

from autovfx_tpu_torch.ops import _build, blend_ref
from autovfx_tpu_torch.ops._build import check_tensor
from autovfx_tpu_torch.ops.binning import BinnedSplats
from autovfx_tpu_torch.ops.projection import Splats2D

TILES = (16, 32)  # tile edges the kernel is instantiated for

launches = 0


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


def blend_kernel(
    binned: BinnedSplats, splats: Splats2D, width: int, height: int,
    tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
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

    dev = binned.gid.device
    color = torch.empty((height, width, 3), dtype=f32, device=dev)
    depth = torch.empty((height, width), dtype=f32, device=dev)
    alpha = torch.empty((height, width), dtype=f32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.blend_fwd(
            binned.tile_range.data_ptr(), binned.gid.data_ptr(),
            splats.mean2d.data_ptr(), splats.conic.data_ptr(),
            splats.opacity.data_ptr(), splats.color.data_ptr(),
            splats.depth.data_ptr(), n_tiles, tx, tile, width, height,
            color.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "blend_fwd")
    launches += 1
    return color, depth, alpha
