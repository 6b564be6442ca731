"""Kernel 2 wrapper: duplicate expansion with sort keys (``csrc/duplicate.cu``).

Every live Gaussian i (``tiles_touched[i] > 0``) owns the slots
``[starts[i], starts[i] + tiles_touched[i])`` of a ``budget``-sized
buffer and writes one ``(key, gid)`` pair per tile of its rect, row by
row: ``key = tile << 32 | float_bits(depth[i])``, ``gid = i``.  Slots at
or past ``budget`` are dropped; slots no Gaussian writes hold
``(n_tiles << 32, n)``, which sorts after every real key.

A CUDA tensor goes through the kernel, or the call raises; a CPU tensor
goes through ``duplicate_with_keys_plain``, a ``repeat_interleave``
expansion of the same map.  The kernel writes every slot below the
budget, the sentinel ones too, so its buffers are allocated unfilled.
"""
from __future__ import annotations

import torch

from autovfx_tpu_torch.ops import _build
from autovfx_tpu_torch.ops._build import check_tensor
from autovfx_tpu_torch.utils import trace


def depth_bits(depth: torch.Tensor) -> torch.Tensor:
    """int64 holding the float32 bit pattern of ``depth`` (order-preserving
    for positive depths)."""
    return depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def duplicate_with_keys(
    tiles_touched: torch.Tensor,  # (N,) int32
    starts: torch.Tensor,  # (N,) int64 exclusive cumsum of tiles_touched
    tile_min: torch.Tensor,  # (N, 2) int32
    tile_max: torch.Tensor,  # (N, 2) int32
    depth: torch.Tensor,  # (N,) f32
    tiles_x: int,
    n_tiles: int,
    budget: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``keys`` (budget,) int64 and ``gids`` (budget,) int32."""
    fn = (duplicate_with_keys_kernel if tiles_touched.is_cuda
          else duplicate_with_keys_plain)
    return fn(tiles_touched, starts, tile_min, tile_max, depth, tiles_x,
              n_tiles, budget)


def duplicate_with_keys_kernel(
    tiles_touched, starts, tile_min, tile_max, depth, tiles_x: int,
    n_tiles: int, budget: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    n = tiles_touched.shape[0]
    check_tensor(tiles_touched, "tiles_touched", torch.int32, (n,))
    check_tensor(starts, "starts", torch.int64, (n,))
    check_tensor(tile_min, "tile_min", torch.int32, (n, 2))
    check_tensor(tile_max, "tile_max", torch.int32, (n, 2))
    check_tensor(depth, "depth", torch.float32, (n,))
    dev = tiles_touched.device
    keys = torch.empty((budget,), dtype=torch.int64, device=dev)
    gids = torch.empty((budget,), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.duplicate_with_keys(
            n, tiles_touched.data_ptr(), starts.data_ptr(),
            tile_min.data_ptr(), tile_max.data_ptr(), depth.data_ptr(),
            tiles_x, n_tiles, budget, keys.data_ptr(), gids.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "duplicate_with_keys")
    trace.count("launch.duplicate_with_keys")
    return keys, gids


def duplicate_with_keys_plain(
    tiles_touched, starts, tile_min, tile_max, depth, tiles_x: int,
    n_tiles: int, budget: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same map with ``repeat_interleave`` (its output size makes a
    CUDA tensor wait for the device once)."""
    n = tiles_touched.shape[0]
    dev = tiles_touched.device
    keys = torch.full((budget,), n_tiles << 32, dtype=torch.int64, device=dev)
    gids = torch.full((budget,), n, dtype=torch.int32, device=dev)
    gid = torch.repeat_interleave(
        torch.arange(n, device=dev), tiles_touched.to(torch.int64)
    )[:budget]
    rank = torch.arange(gid.shape[0], device=dev) - starts[gid]
    x0 = tile_min[gid, 0].to(torch.int64)
    y0 = tile_min[gid, 1].to(torch.int64)
    w = (tile_max[gid, 0] - tile_min[gid, 0]).to(torch.int64)
    dy = torch.div(rank, w, rounding_mode="floor")
    tile = (y0 + dy) * tiles_x + x0 + (rank - dy * w)
    keys[: gid.shape[0]] = (tile << 32) | depth_bits(depth)[gid]
    gids[: gid.shape[0]] = gid.to(torch.int32)
    return keys, gids
