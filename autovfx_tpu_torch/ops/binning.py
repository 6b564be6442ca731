"""Tile binning: duplicate expansion, one stable key sort, tile ranges.

Counterpart of ``autovfx_tpu/ops/binning.py``, ported by its output
contract and not by its TPU layout.  The steps follow the CUDA
rasterizer's ``rasterizer_impl.cu`` (InclusiveSum, duplicateWithKeys,
SortPairs, identifyTileRanges):

1. an exclusive ``torch.cumsum`` of ``tiles_touched`` in int64 gives
   each live Gaussian its first duplicate slot;
2. ``fill_cuda.duplicate_with_keys`` (kernel 2) writes one
   ``(key = tile << 32 | float_bits(depth), gid)`` pair per covered tile;
3. one ``torch.sort(keys, stable=True)``: depth is > NEAR_Z > 0 for every
   live Gaussian, so its bits order like the floats, and the stable sort
   keeps equal depths in original-index order (the order of the JAX
   package's stable depth presort + stable tile sort);
4. ``searchsorted`` of the sorted keys at every tile's key boundary
   gives the ``[start, end)`` range of each tile.

Not ported: the depth presort, the monotone/segment fills and the
interval-indicator tile-count matmul (the tile ranges replace them),
the per-tile chunk pads and ``tile_chunks`` (a Mosaic DMA layout), and
the TPU guards on ``chunk % 128`` and on values ``< 2**24``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from autovfx_tpu_torch.ops import fill_cuda
from autovfx_tpu_torch.ops.projection import TILE, Splats2D, num_tiles
from autovfx_tpu_torch.utils import trace


class BinnedSplats(NamedTuple):
    """Tile-sorted splat duplicates.

    ``overflow`` is True when the view needs more duplicates than
    ``dup_budget``.  The budget is then truncated: only slots below it
    are written (the duplicates of the lowest Gaussian ids), the tile
    ranges describe exactly what was kept, and the render stays finite
    but misses the dropped duplicates.  ``total_dups`` is the count the
    view asked for, before truncation.
    """

    gid: torch.Tensor  # (K,) int32 original Gaussian id; N on unused slots
    tile: torch.Tensor  # (K,) int32 tile id; num_tiles on unused slots
    tile_range: torch.Tensor  # (T, 2) int32 [start, end) into gid
    num_tiles_x: int
    num_tiles_y: int
    total_dups: torch.Tensor  # () int64
    overflow: torch.Tensor  # () bool


def expand_duplicates(
    splats: Splats2D, tiles_x: int, n_tiles: int, budget: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Steps 1-2: ``(keys (K,) int64, gids (K,) int32, total () int64)``."""
    counts = splats.tiles_touched
    ends = torch.cumsum(counts, 0)  # int64: offsets never wrap
    starts = ends - counts
    total = ends[-1] if counts.numel() else ends.new_zeros(())
    keys, gids = fill_cuda.duplicate_with_keys(  # integer work: no gradient
        counts, starts, splats.tile_min, splats.tile_max,
        splats.depth.detach(), tiles_x, n_tiles, budget,
    )
    return keys, gids, total


def sort_duplicates(
    keys: torch.Tensor, gids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 3: stable sort by key; returns sorted keys and their gids."""
    keys_s, order = torch.sort(keys, stable=True)
    return keys_s, gids[order]


def tile_ranges(keys_s: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """Step 4: (T, 2) int32 ``[start, end)`` of every tile in ``keys_s``."""
    bounds = torch.arange(n_tiles + 1, dtype=torch.int64,
                          device=keys_s.device) << 32
    b = torch.searchsorted(keys_s, bounds, out_int32=True)
    return torch.stack([b[:-1], b[1:]], dim=1)


def bin_splats(
    splats: Splats2D,
    width: int,
    height: int,
    dup_budget: int,
    tile: int = TILE,
) -> BinnedSplats:
    """Bin a view's splats into tiles with a fixed ``dup_budget``-slot
    allocation (no host sync).  Traced, the duplicates asked for and the
    slots sorted are the counters ``raster.dups`` and ``raster.slots``."""
    if not 0 < dup_budget < 2**31:
        raise ValueError(
            f"dup_budget must be in (0, 2**31): gids and tile ranges are "
            f"int32 (got {dup_budget})"
        )
    tiles_x, tiles_y = num_tiles(width, height, tile)
    n_tiles = tiles_x * tiles_y
    with trace.span("raster.binning"):
        keys, gids, total = expand_duplicates(splats, tiles_x, n_tiles,
                                              dup_budget)
        keys_s, gid_s = sort_duplicates(keys, gids)
        binned = BinnedSplats(
            gid=gid_s,
            tile=(keys_s >> 32).to(torch.int32),
            tile_range=tile_ranges(keys_s, n_tiles),
            num_tiles_x=tiles_x,
            num_tiles_y=tiles_y,
            total_dups=total,
            overflow=total > dup_budget,
        )
    trace.count_device("raster.dups", total)
    if trace.enabled():
        trace.count("raster.slots", dup_budget)
    return binned


def required_budget(splats: Splats2D) -> torch.Tensor:
    """Live duplicates this view needs (no pad term): a () int64 tensor
    for host-side budget sizing."""
    return splats.tiles_touched.sum(dtype=torch.int64)


BUDGET_MULTIPLE = 4096  # budgets differ in whole steps, so allocations repeat


def round_budget(n: int, slack: float = 1.25) -> int:
    """Pad a measured duplicate count to a reusable budget: ``slack``
    headroom for other views, rounded up to ``BUDGET_MULTIPLE`` slots."""
    return int(math.ceil(n * slack / BUDGET_MULTIPLE) * BUDGET_MULTIPLE)
