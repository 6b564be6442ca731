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

``blend_tiles_ref_bwd`` is the plain backward (kernel 4's contract): the
same per-tile vectorization, with a float64 suffix sum for the
back-to-front terms and an ``index_add_`` by gid.  ``ambiguous_pixels``
marks the pixels where a float32 kernel may decide a duplicate
otherwise.  ``patch_mask_plain`` is the kernels' proof that a duplicate
blends no pixel of a warp patch (``csrc/blend_common.cuh``);
``last_blended`` is the training forward's ``n_contrib``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from autovfx_tpu_torch.ops.binning import BinnedSplats
from autovfx_tpu_torch.ops.projection import TILE, Splats2D

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class SplatGrads(NamedTuple):
    """Per-Gaussian gradients of the blend's inputs (``Splats2D`` fields)."""

    mean2d: torch.Tensor  # (N, 2)
    conic: torch.Tensor  # (N, 3)
    opacity: torch.Tensor  # (N,)
    color: torch.Tensor  # (N, 3)
    depth: torch.Tensor  # (N,)


class _Dups(NamedTuple):
    """The duplicates of the selected tiles, in tile then depth order."""

    tiles: torch.Tensor  # (S,) int64 selected tile ids
    seg: torch.Tensor  # (K_sel,) position of the duplicate's tile in ``tiles``
    seg_start: torch.Tensor  # (K_sel,) first index of that tile's run
    seg_end: torch.Tensor  # (K_sel,) last index of that tile's run
    gid: torch.Tensor  # (K_sel,) int64 Gaussian id
    px: torch.Tensor  # (K_sel, tile²) f32 pixel x of the duplicate's tile
    py: torch.Tensor  # (K_sel, tile²)


def _duplicates(binned: BinnedSplats, tile: int, tiles) -> _Dups:
    dev = binned.gid.device
    if tiles is None:
        tiles = torch.arange(binned.tile_range.shape[0], device=dev)
    tiles = tiles.to(torch.int64)
    rng = binned.tile_range[tiles].to(torch.int64)  # (S, 2)
    counts = rng[:, 1] - rng[:, 0]
    seg = torch.repeat_interleave(torch.arange(tiles.shape[0], device=dev),
                                  counts)
    ends = torch.cumsum(counts, 0)
    seg_start = (ends - counts)[seg]
    pos = torch.arange(seg.shape[0], device=dev)
    g = binned.gid[rng[seg, 0] + pos - seg_start].to(torch.int64)
    t = tiles[seg]
    tiles_x = binned.num_tiles_x
    p = torch.arange(tile * tile, device=dev)
    px = ((t % tiles_x) * tile)[:, None] + (p % tile)[None, :]
    py = ((t // tiles_x) * tile)[:, None] + (p // tile)[None, :]
    return _Dups(tiles, seg, seg_start, ends[seg] - 1, g,
                 px.to(torch.float32), py.to(torch.float32))


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


def _seg_cumsum(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """float64 inclusive cumsum of ``x`` along dim 0, restarted at every
    tile's first duplicate."""
    cum = torch.cumsum(x.to(torch.float64), dim=0)
    base = torch.where((seg_start > 0)[:, None],
                       cum[(seg_start - 1).clamp(min=0)],
                       torch.zeros_like(cum[:1]))
    return cum - base


def _seg_exclusive(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """float32 sum of ``x`` over the earlier duplicates of the same tile,
    clamped to <= 0 (a log-transmittance never exceeds 0)."""
    return torch.clamp(_seg_cumsum(x, seg_start) - x, max=0.0).to(torch.float32)


def patch_mask_plain(
    mean2d: torch.Tensor,  # (K, 2)
    conic: torch.Tensor,  # (K, 3)
    opacity: torch.Tensor,  # (K,)
    ox: torch.Tensor,  # (K,) the origin of each duplicate's tile
    oy: torch.Tensor,
    tile: int,
) -> torch.Tensor:
    """(K, 8) bool: ``patch_mask`` of ``csrc/blend_common.cuh`` for a
    batch of duplicates, bit w in column w.  False proves that the
    duplicate blends no pixel of warp patch w (8Q x 4Q pixels at (w & 1)
    * 8Q, (w >> 1) * 4Q of the tile, Q = tile / 16): such a pixel has q =
    dᵀ·conic·d within the bounding box of q <= 2 (ln(255 op) + 1e-5) /
    (1 - 1e-5 G), G = (1 + ρ) / (1 - ρ), ρ = |b| / sqrt(ac), computed in
    float64.  True everywhere where an input is not finite or the bound
    does not hold."""
    q = tile // 16
    x, y = mean2d.double().unbind(1)
    a, b, c = conic.double().unbind(1)
    op = opacity.double()
    finite = torch.isfinite(mean2d).all(1) & torch.isfinite(conic).all(1) \
        & torch.isfinite(opacity)
    det = a * c - b * b
    bounded = finite & (a > 0) & (c > 0) & (det > 0)
    rho = b.abs() / torch.sqrt(a * c)
    slack = 1e-5 * (1.0 + rho) / (1.0 - rho)
    bounded &= slack < 0.5
    r2 = 2.0 * (torch.log(255.0 * op) + 1e-5) / (1.0 - slack)
    empty = ~(255.0 * op > 0) | (r2 < 0)
    hx = torch.sqrt(r2 * c / det)[:, None]
    hy = torch.sqrt(r2 * a / det)[:, None]
    w = torch.arange(8, device=mean2d.device)
    x0 = (ox[:, None] + (w & 1) * 8 * q).double()
    y0 = (oy[:, None] + (w >> 1) * 4 * q).double()
    hit = ((x[:, None] + hx >= x0) & (x[:, None] - hx <= x0 + (8 * q - 1))
           & (y[:, None] + hy >= y0) & (y[:, None] - hy <= y0 + (4 * q - 1)))
    hit &= ~empty[:, None]
    return torch.where(bounded[:, None], hit, torch.ones_like(hit))


def pixel_patch(tile: int, device=None) -> torch.Tensor:
    """(tile²,) the warp patch of each pixel of a tile (row-major)."""
    q = tile // 16
    p = torch.arange(tile * tile, device=device)
    return (p % tile) // (8 * q) + 2 * ((p // tile) // (4 * q))


def _patch_kept(d: _Dups, splats: Splats2D, binned: BinnedSplats,
                tile: int) -> torch.Tensor:
    """(K_sel, tile²) bool: False at the pixels of the patches each
    duplicate provably misses (``patch_mask_plain``)."""
    g = d.gid
    t = d.tiles[d.seg]
    tx = binned.num_tiles_x
    mask = patch_mask_plain(splats.mean2d[g], splats.conic[g],
                            splats.opacity[g], (t % tx) * tile,
                            (t // tx) * tile, tile)
    return mask[:, pixel_patch(tile, g.device)]


def blend_tiles_ref(
    binned: BinnedSplats,
    splats: Splats2D,
    tile: int = TILE,
    tiles: Optional[torch.Tensor] = None,
) -> TileImages:
    """Blend the tiles listed in ``tiles`` (default: all), reading each
    duplicate's features from ``splats`` by its gid."""
    dev = binned.gid.device
    d = _duplicates(binned, tile, tiles)
    s, seg, seg_start, g = d.tiles.shape[0], d.seg, d.seg_start, d.gid
    alpha = compute_alpha(
        splats.mean2d[g], splats.conic[g], splats.opacity[g], d.px, d.py,
    )  # (K_sel, P)
    log_t = _seg_exclusive(torch.log1p(-alpha), seg_start)
    frozen = torch.exp(log_t) * (1.0 - alpha) < T_EPS
    alpha_hat = torch.where(frozen, torch.zeros_like(alpha), alpha)
    lg_hat = torch.log1p(-alpha_hat)
    w = alpha_hat * torch.exp(_seg_exclusive(lg_hat, seg_start))

    npix = tile * tile
    color = torch.zeros((s, npix, 3), device=dev).index_add_(
        0, seg, w[:, :, None] * splats.color[g][:, None, :]
    )
    depth = torch.zeros((s, npix), device=dev).index_add_(
        0, seg, w * splats.depth[g][:, None]
    )
    total_lg = torch.zeros((s, npix), device=dev).index_add_(0, seg, lg_hat)
    return TileImages(color=color, depth=depth, alpha=1.0 - torch.exp(total_lg))


def blend_tiles_ref_bwd(
    binned: BinnedSplats,
    splats: Splats2D,
    g_color: torch.Tensor,
    g_depth: torch.Tensor,
    g_alpha: torch.Tensor,
    tile: int = TILE,
    tiles: Optional[torch.Tensor] = None,
) -> SplatGrads:
    """Gradients of the blend's inputs from the output images' gradients
    ``g_color`` (H, W, 3), ``g_depth`` (H, W) and ``g_alpha`` (H, W), over
    the pixels of ``tiles`` (default: all): what kernel 4
    (``csrc/blend_bwd.cu``) is held against.

    An explicit function, not autograd, with ``backward.cu`` renderCUDA's
    conventions.  With f = g_C·c + g_D·d at a pixel, T_k the transmittance
    before duplicate k, T_N the final one and S_k = Σ_{j>k} α_j T_j f_j,

        dL/dα_k = T_k f_k − (S_k − g_A T_N) / (1 − α_k)

    for every blended duplicate (the frozen ones and the skipped ones get
    nothing), and the 0.99 clamp is straight-through: dL/dpower =
    op·exp(power)·dL/dα and dL/dop = exp(power)·dL/dα.  Prefix and
    suffix sums run in float64, like the forward's."""
    dev = binned.gid.device
    d = _duplicates(binned, tile, tiles)
    seg, seg_start, g = d.seg, d.seg_start, d.gid
    tx, ty = binned.num_tiles_x, binned.num_tiles_y

    def pick(img):  # (H, W, ...) -> (K_sel, tile², ...) at each duplicate
        return split_tiles(img, tx, ty, tile)[d.tiles][seg]

    mean2d, conic = splats.mean2d[g], splats.conic[g]
    dx = mean2d[:, 0:1] - d.px
    dy = mean2d[:, 1:2] - d.py
    ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    gauss = torch.exp(power)
    a_un = splats.opacity[g][:, None] * gauss
    alpha = torch.clamp(a_un, max=ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    log_t = _seg_exclusive(torch.log1p(-alpha), seg_start)
    live = ok & ~(torch.exp(log_t) * (1.0 - alpha) < T_EPS)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    lg = torch.log1p(-alpha)
    t_k = torch.exp(_seg_exclusive(lg, seg_start))
    t_n = torch.exp(_seg_cumsum(lg, seg_start)[d.seg_end]).to(torch.float32)
    w = alpha * t_k

    gc = pick(g_color)
    f = (gc * splats.color[g][:, None, :]).sum(-1) + pick(g_depth) * \
        splats.depth[g][:, None]
    incl = _seg_cumsum(w * f, seg_start)
    s_k = (incl[d.seg_end] - incl).to(torch.float32)
    dl_da = t_k * f - (s_k - pick(g_alpha) * t_n) / (1.0 - alpha)
    zero = torch.zeros_like(dl_da)
    dpower = torch.where(live, a_un * dl_da, zero)

    n = splats.depth.shape[0]
    sum_p = lambda x: x.sum(dim=1)

    def scatter(rows):  # (K_sel, C) per duplicate -> (N, C) per Gaussian
        return torch.zeros((n, rows.shape[1]), device=dev).index_add_(0, g, rows)

    d_mean2d = scatter(torch.stack([sum_p(-dpower * (ca * dx + cb * dy)),
                                    sum_p(-dpower * (cb * dx + cc * dy))], 1))
    d_conic = scatter(torch.stack([sum_p(-0.5 * dpower * dx * dx),
                                   sum_p(-dpower * dx * dy),
                                   sum_p(-0.5 * dpower * dy * dy)], 1))
    d_op = scatter(sum_p(torch.where(live, gauss * dl_da, zero))[:, None])
    d_color = scatter((w[:, :, None] * gc).sum(dim=1))
    d_depth = scatter(sum_p(w * pick(g_depth))[:, None])
    return SplatGrads(mean2d=d_mean2d, conic=d_conic, opacity=d_op[:, 0],
                      color=d_color, depth=d_depth[:, 0])


def blended_pairs(
    binned: BinnedSplats,
    splats: Splats2D,
    tile: int = TILE,
    tiles: Optional[torch.Tensor] = None,
) -> tuple[_Dups, torch.Tensor]:
    """The duplicates of ``tiles`` (default: all) and the (K_sel, tile²)
    bool of the pairs the blend blends: alpha >= 1/255, power <= 0 and
    before the pixel freezes."""
    d = _duplicates(binned, tile, tiles)
    g = d.gid
    alpha = compute_alpha(splats.mean2d[g], splats.conic[g],
                          splats.opacity[g], d.px, d.py)
    log_t = _seg_exclusive(torch.log1p(-alpha), d.seg_start)
    return d, (alpha > 0) & ~(torch.exp(log_t) * (1.0 - alpha) < T_EPS)


def last_blended(
    binned: BinnedSplats,
    splats: Splats2D,
    tile: int = TILE,
    tiles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(S, tile²) int32 over the pixels of ``tiles`` (default: all): the
    leading duplicates of the tile up to and including the last one the
    pixel blends (0 if none), the training forward's ``n_contrib``."""
    d, live = blended_pairs(binned, splats, tile, tiles)
    rank = torch.arange(d.gid.shape[0], device=d.gid.device) - d.seg_start + 1
    last = torch.where(live, rank[:, None], torch.zeros_like(rank[:, None]))
    out = torch.zeros((d.tiles.shape[0], tile * tile), dtype=torch.int64,
                      device=d.gid.device)
    out.scatter_reduce_(0, d.seg[:, None].expand_as(last), last, "amax")
    return out.to(torch.int32)


def ambiguous_pixels(
    binned: BinnedSplats,
    splats: Splats2D,
    tile: int = TILE,
    tiles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(S, tile²) bool over the pixels of ``tiles`` (default: all): True
    where the blend decides about a duplicate it reaches (skip at power
    > 0 or alpha < 1/255, freeze at T·(1 - alpha) < 1e-4) within float32
    rounding of the threshold.

    A kernel rounds the power's terms in another order (it contracts
    them into FMAs) and multiplies T step by step where this module sums
    logarithms, so at such a pixel it may blend one duplicate more or
    less; the pixel's gradients then differ by that duplicate's whole
    share, which at the edge of a large splat is ~1e-2 of the splat's
    conic gradient.  Checks of kernel 4 zero the output gradients there.
    The margins: 8 ulps of the power's largest terms plus 1e-6 for exp
    and the opacity product; 4 ulps of log T per factor plus 2e-6."""
    d = _duplicates(binned, tile, tiles)
    g, eps = d.gid, 2.0 ** -24
    mean2d, conic = splats.mean2d[g].double(), splats.conic[g].double()
    dx = mean2d[:, 0:1] - d.px.double()
    dy = mean2d[:, 1:2] - d.py.double()
    ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    margin = 8 * eps * (0.5 * (ca.abs() * dx * dx + cc.abs() * dy * dy)
                        + (cb * dx * dy).abs())  # 0 where power is exact
    cut = torch.log(ALPHA_MIN / splats.opacity[g].double()
                    .clamp(min=1e-30))[:, None]  # alpha = 1/255 here
    near_skip = ((power.abs() < margin)
                 | ((power - cut).abs() <= margin + 1e-6))

    alpha = compute_alpha(splats.mean2d[g], splats.conic[g],
                          splats.opacity[g], d.px, d.py)
    lg = torch.log1p(-alpha.double())
    log_t = _seg_cumsum(lg, d.seg_start) - lg  # before the duplicate
    n = _seg_cumsum((alpha > 0).double(), d.seg_start)
    window = 4 * eps * (n + 1) + 2e-6
    log_eps = torch.log(torch.tensor(T_EPS, dtype=torch.float64))
    reached = log_t >= log_eps - window  # not frozen before it
    near_freeze = (alpha > 0) & ((log_t + lg - log_eps).abs() <= window)
    near = (near_skip & reached) | near_freeze
    counts = torch.zeros((d.tiles.shape[0], tile * tile), dtype=torch.int32,
                         device=g.device)
    return counts.index_add_(0, d.seg, near.to(torch.int32)) > 0


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
