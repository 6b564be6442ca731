"""Plain tile blend: what a CPU tensor goes through and what kernel 3
(``csrc/blend_fwd.cu``) is held against.

Counterpart of ``autovfx_tpu/ops/blend_ref.py:29-131``, with the
semantics of ``forward.cu`` renderCUDA: alpha = min(0.99, op·exp(power)),
a duplicate is skipped where power > 0 or alpha < 1/255, a pixel freezes
for good at the first duplicate whose ``test_T = T·(1 - alpha)`` falls
below 1e-4 (that duplicate is not blended), color and depth are the
``alpha·T``-weighted sums and alpha = 1 - T.  The background term is the
caller's.

The per-pixel sequential loop becomes a segmented exclusive prefix sum
of ``log(1 - alpha)`` over each tile's depth-sorted duplicates; the
freeze is exact because ``test_T`` only decreases along a tile.  The
prefix runs in float64: a float32 running sum over ~10^5 duplicates
would lose ~1e-3 of log-transmittance to cancellation.

Memory is O(K_sel · tile²) for the K_sel duplicates of the chosen tiles,
so ``tiles`` lets a caller blend a subset of a full-size frame.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from autovfx_tpu_torch.ops.binning import BinnedSplats
from autovfx_tpu_torch.ops.projection import TILE, Splats2D

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class TileImages(NamedTuple):
    color: torch.Tensor  # (S, tile², 3)
    depth: torch.Tensor  # (S, tile²)
    alpha: torch.Tensor  # (S, tile²)


def compute_alpha(mean2d, conic, opacity, px, py):
    """renderCUDA alpha for (K,) splats × (K, P) pixels; 0 where skipped."""
    dx = mean2d[:, 0:1] - px
    dy = mean2d[:, 1:2] - py
    power = (
        -0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy)
        - conic[:, 1:2] * dx * dy
    )
    alpha = torch.clamp(opacity[:, None] * torch.exp(power), max=ALPHA_MAX)
    valid = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(valid, alpha, torch.zeros_like(alpha))


def blend_tiles_ref(
    binned: BinnedSplats,
    splats: Splats2D,
    tile: int = TILE,
    tiles: Optional[torch.Tensor] = None,
) -> TileImages:
    """Blend the tiles listed in ``tiles`` (default: all), reading each
    duplicate's features from ``splats`` by its gid."""
    dev = binned.gid.device
    n_tiles = binned.tile_range.shape[0]
    if tiles is None:
        tiles = torch.arange(n_tiles, device=dev)
    tiles = tiles.to(torch.int64)
    s = tiles.shape[0]
    rng = binned.tile_range[tiles].to(torch.int64)  # (S, 2)
    counts = rng[:, 1] - rng[:, 0]
    seg = torch.repeat_interleave(torch.arange(s, device=dev), counts)
    seg_start = (torch.cumsum(counts, 0) - counts)[seg]  # (K_sel,)
    pos = torch.arange(seg.shape[0], device=dev)
    g = binned.gid[rng[seg, 0] + pos - seg_start].to(torch.int64)

    t = tiles[seg]
    tiles_x = binned.num_tiles_x
    p = torch.arange(tile * tile, device=dev)
    px = ((t % tiles_x) * tile)[:, None] + (p % tile)[None, :]
    py = ((t // tiles_x) * tile)[:, None] + (p // tile)[None, :]
    alpha = compute_alpha(
        splats.mean2d[g], splats.conic[g], splats.opacity[g],
        px.to(torch.float32), py.to(torch.float32),
    )  # (K_sel, P)

    has_base = (seg_start > 0)[:, None]
    base_idx = (seg_start - 1).clamp(min=0)

    def seg_exclusive(x):
        cum = torch.cumsum(x.to(torch.float64), dim=0)
        base = torch.where(has_base, cum[base_idx], torch.zeros_like(cum[:1]))
        # transmittance never exceeds 1 (rounding guard)
        return torch.clamp(cum - x - base, max=0.0).to(torch.float32)

    log_t = seg_exclusive(torch.log1p(-alpha))
    frozen = torch.exp(log_t) * (1.0 - alpha) < T_EPS
    alpha_hat = torch.where(frozen, torch.zeros_like(alpha), alpha)
    lg_hat = torch.log1p(-alpha_hat)
    w = alpha_hat * torch.exp(seg_exclusive(lg_hat))

    npix = tile * tile
    color = torch.zeros((s, npix, 3), device=dev).index_add_(
        0, seg, w[:, :, None] * splats.color[g][:, None, :]
    )
    depth = torch.zeros((s, npix), device=dev).index_add_(
        0, seg, w * splats.depth[g][:, None]
    )
    total_lg = torch.zeros((s, npix), device=dev).index_add_(0, seg, lg_hat)
    return TileImages(color=color, depth=depth, alpha=1.0 - torch.exp(total_lg))


def assemble_image(
    tile_img: torch.Tensor, tiles_x: int, tiles_y: int, width: int,
    height: int, tile: int = TILE,
) -> torch.Tensor:
    """(T, tile², C?) tile buffers -> (H, W, C?) image (padding cropped)."""
    c_shape = tuple(tile_img.shape[2:])
    img = tile_img.reshape((tiles_y, tiles_x, tile, tile) + c_shape)
    img = img.transpose(1, 2).reshape((tiles_y * tile, tiles_x * tile) + c_shape)
    return img[:height, :width]


def split_tiles(
    img: torch.Tensor, tiles_x: int, tiles_y: int, tile: int = TILE
) -> torch.Tensor:
    """Inverse of ``assemble_image``: (H, W, C?) -> (T, tile², C?), with
    the pixels past the image edge zero."""
    h, w = img.shape[:2]
    c_shape = tuple(img.shape[2:])
    full = img.new_zeros((tiles_y * tile, tiles_x * tile) + c_shape)
    full[:h, :w] = img
    t = full.reshape((tiles_y, tile, tiles_x, tile) + c_shape).transpose(1, 2)
    return t.reshape((tiles_y * tiles_x, tile * tile) + c_shape)
