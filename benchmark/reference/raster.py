"""Plain PyTorch splat rasterizer: what a frame and a training step are
held against.

A frozen copy of the program's plain paths as they stood when the
benchmark was written, with no import of the program: the SH colors,
the EWA preprocess (``forward.cu`` preprocessCUDA), the duplicate
expansion and one stable (tile, depth) sort, and the tile blend
(renderCUDA: alpha = min(0.99, op·exp(power)), skipped where power > 0
or alpha < 1/255, a pixel frozen at the first duplicate whose
T·(1 - alpha) falls below 1e-4) as segmented prefix sums of
log(1 - alpha) in float64.  The blend and its backward run over blocks
of tiles of at most ``BLOCK_DUPS`` duplicates, so a full frame fits.

``lowp`` rounds every float the stages hand on (the Gaussians' fields,
the screen-space splats, the images and gradients) to bfloat16: the
controls' path, a bfloat16 feature pack where the configuration states
float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
NEAR_Z = 0.2
COV2D_DILATION = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
BLOCK_DUPS = 1 << 16  # duplicates a blend block holds, about


def rounder(lowp: bool):
    """The identity, or a round trip through bfloat16 for float tensors."""
    if not lowp:
        return lambda x: x
    return lambda x: (x.to(torch.bfloat16).to(x.dtype)
                      if x.is_floating_point() else x)


class Cam(NamedTuple):
    """A camera as tensors on the run's device (``scene.View``'s numbers)."""

    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    center: torch.Tensor  # (3,)
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def cam_of(view, device) -> Cam:
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return Cam(f(view.R), f(view.t), f(view.center), view.fx, view.fy,
               view.cx, view.cy, view.width, view.height)


class Splats(NamedTuple):
    mean2d: torch.Tensor  # (N, 2)
    conic: torch.Tensor  # (N, 3)
    color: torch.Tensor  # (N, 3)
    opacity: torch.Tensor  # (N,)
    depth: torch.Tensor  # (N,)
    tile_min: torch.Tensor  # (N, 2) int64
    tile_max: torch.Tensor  # (N, 2) int64
    tiles_touched: torch.Tensor  # (N,) int64


def sh_color(sh_dc, sh_rest, xyz, center, degree: int = 3):
    """max(SH(dir) + 0.5, 0) toward the camera, bands 0..``degree``."""
    d = xyz - center[None]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    sh = torch.cat([sh_dc[:, None], sh_rest], dim=1)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    r = SH_C0 * sh[:, 0]
    if degree >= 1:
        r = r - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        r = (r + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
             + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
             + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        r = (r + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
             + SH_C3[1] * xy * z * sh[:, 10]
             + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
             + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
             + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
             + SH_C3[5] * z * (xx - yy) * sh[:, 14]
             + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.clamp(r + 0.5, min=0.0)


def preprocess(g: dict, cam: Cam, tile: int, lowp: bool = False) -> Splats:
    """Project the Gaussians ``g`` (the scene's fields) to screen space.
    Differentiable in the float fields."""
    q = rounder(lowp)
    xyz, quats = q(g["xyz"]), q(g["quats"])
    tiles_x = (cam.width + tile - 1) // tile
    tiles_y = (cam.height + tile - 1) // tile
    R, t = cam.R, cam.t
    px_, py_, pz_ = xyz.unbind(-1)
    p_view = [px_ * R[i, 0] + py_ * R[i, 1] + pz_ * R[i, 2] + t[i]
              for i in range(3)]
    depth = p_view[2]
    in_front = depth > NEAR_Z
    safe_z = torch.where(in_front, depth, torch.ones_like(depth))
    mean2d = torch.stack([cam.fx * p_view[0] / safe_z + cam.cx - 0.5,
                          cam.fy * p_view[1] / safe_z + cam.cy - 0.5], -1)
    limx = 1.3 * (0.5 * cam.width / cam.fx)
    limy = 1.3 * (0.5 * cam.height / cam.fy)
    tx = torch.clamp(p_view[0] / safe_z, -limx, limx) * safe_z
    ty = torch.clamp(p_view[1] / safe_z, -limy, limy) * safe_z
    tz = safe_z

    qn = quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True),
                             min=1e-12)
    w, x, y, z = qn.unbind(-1)
    r = [[1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
          2.0 * (x * z + w * y)],
         [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
          2.0 * (y * z - w * x)],
         [2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
          1.0 - 2.0 * (x * x + y * y)]]
    s = torch.exp(q(g["log_scales"]))
    s2 = [s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2]
    cov = lambda i, j: sum(s2[k] * r[i][k] * r[j][k] for k in range(3))
    c_xx, c_xy, c_xz = cov(0, 0), cov(0, 1), cov(0, 2)
    c_yy, c_yz, c_zz = cov(1, 1), cov(1, 2), cov(2, 2)

    j00 = cam.fx / tz
    j02 = -(cam.fx * tx) / (tz * tz)
    j11 = cam.fy / tz
    j12 = -(cam.fy * ty) / (tz * tz)
    m0 = [j00 * R[0, i] + j02 * R[2, i] for i in range(3)]
    m1 = [j11 * R[1, i] + j12 * R[2, i] for i in range(3)]

    def sigma_dot(v):
        return (c_xx * v[0] + c_xy * v[1] + c_xz * v[2],
                c_xy * v[0] + c_yy * v[1] + c_yz * v[2],
                c_xz * v[0] + c_yz * v[1] + c_zz * v[2])

    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    s_m0, s_m1 = sigma_dot(m0), sigma_dot(m1)
    cov_a = dot(m0, s_m0) + COV2D_DILATION
    cov_b = dot(m0, s_m1)
    cov_c = dot(m1, s_m1) + COV2D_DILATION
    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det != 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cov_c / safe_det, -cov_b / safe_det,
                         cov_a / safe_det], -1)

    mid = 0.5 * (cov_a + cov_c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    op = torch.sigmoid(q(g["opacity_logit"])) * g["active"].to(torch.float32)
    nsigma = torch.sqrt(2.0 * torch.log(torch.clamp(op * 255.0,
                                                    min=1.0 + 1e-6)))
    radius_f = torch.ceil(torch.clamp(nsigma, max=3.0) * torch.sqrt(lambda1))
    rx = torch.ceil(torch.minimum(nsigma * torch.sqrt(cov_a) + 1.0, radius_f))
    ry = torch.ceil(torch.minimum(nsigma * torch.sqrt(cov_c) + 1.0, radius_f))
    mx, my = mean2d[:, 0].detach(), mean2d[:, 1].detach()
    rx, ry = rx.detach(), ry.detach()

    def rect(v, hi):
        return torch.clamp(v, 0.0, float(hi)).to(torch.int32).to(torch.int64)

    rmin_x = rect((mx - rx) / tile, tiles_x)
    rmin_y = rect((my - ry) / tile, tiles_y)
    rmax_x = rect((mx + rx + tile - 1) / tile, tiles_x)
    rmax_y = rect((my + ry + tile - 1) / tile, tiles_y)
    area = (rmax_x - rmin_x) * (rmax_y - rmin_y)
    valid = in_front & det_ok & (area > 0) & g["active"]
    area = torch.where(valid, area, torch.zeros_like(area))
    color = sh_color(q(g["sh_dc"]), q(g["sh_rest"]), xyz, cam.center)
    return Splats(
        mean2d=q(mean2d), conic=q(conic), color=q(color),
        opacity=q(torch.where(valid, op, torch.zeros_like(op))),
        depth=depth.to(torch.float32) if not lowp else q(depth),
        tile_min=torch.stack([rmin_x, rmin_y], -1),
        tile_max=torch.stack([rmax_x, rmax_y], -1), tiles_touched=area)


def join(parts: list) -> Splats:
    """Several sets' splats as one scene (gids in set order)."""
    return Splats(*(torch.cat(x) for x in zip(*parts)))


class Binned(NamedTuple):
    gid: torch.Tensor  # (K,) int64, tile then depth order
    tile_range: torch.Tensor  # (T, 2) int64
    tiles_x: int
    tiles_y: int
    total: int  # duplicates the view needs


def depth_bits(depth: torch.Tensor) -> torch.Tensor:
    return (depth.detach().to(torch.float32).contiguous().view(torch.int32)
            .to(torch.int64) & 0xFFFFFFFF)


def bin_splats(s: Splats, width: int, height: int, tile: int) -> Binned:
    """Every duplicate a splat's tile rect asks for, sorted stably by
    (tile, depth), equal keys in gid order; no budget."""
    tiles_x = (width + tile - 1) // tile
    tiles_y = (height + tile - 1) // tile
    n_tiles = tiles_x * tiles_y
    dev = s.depth.device
    counts = s.tiles_touched
    gid = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                  counts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(gid.shape[0], device=dev) - starts[gid]
    x0, y0 = s.tile_min[gid, 0], s.tile_min[gid, 1]
    w = s.tile_max[gid, 0] - x0
    dy = torch.div(rank, w, rounding_mode="floor")
    tile_id = (y0 + dy) * tiles_x + x0 + (rank - dy * w)
    keys = (tile_id << 32) | depth_bits(s.depth)[gid]
    keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(n_tiles + 1, dtype=torch.int64, device=dev) << 32
    b = torch.searchsorted(keys, bounds)
    return Binned(gid=gid[order], tile_range=torch.stack([b[:-1], b[1:]], 1),
                  tiles_x=tiles_x, tiles_y=tiles_y, total=int(gid.shape[0]))


def tile_blocks(b: Binned) -> list[torch.Tensor]:
    """The tiles in consecutive blocks of at most ``BLOCK_DUPS``
    duplicates (a larger tile alone)."""
    counts = (b.tile_range[:, 1] - b.tile_range[:, 0]).tolist()
    dev = b.gid.device
    blocks, start, held = [], 0, 0
    for i, c in enumerate(counts):
        if held and held + c > BLOCK_DUPS:
            blocks.append(torch.arange(start, i, device=dev))
            start, held = i, 0
        held += c
    blocks.append(torch.arange(start, len(counts), device=dev))
    return blocks


class _Dups(NamedTuple):
    seg: torch.Tensor
    seg_start: torch.Tensor
    seg_end: torch.Tensor
    gid: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor


def _duplicates(b: Binned, tile: int, tiles: torch.Tensor) -> _Dups:
    dev = b.gid.device
    rng = b.tile_range[tiles]
    counts = rng[:, 1] - rng[:, 0]
    seg = torch.repeat_interleave(torch.arange(tiles.shape[0], device=dev),
                                  counts)
    ends = torch.cumsum(counts, 0)
    seg_start = (ends - counts)[seg]
    pos = torch.arange(seg.shape[0], device=dev)
    g = b.gid[rng[seg, 0] + pos - seg_start]
    t = tiles[seg]
    p = torch.arange(tile * tile, device=dev)
    px = ((t % b.tiles_x) * tile)[:, None] + (p % tile)[None, :]
    py = ((t // b.tiles_x) * tile)[:, None] + (p // tile)[None, :]
    return _Dups(seg, seg_start, ends[seg] - 1, g, px.to(torch.float32),
                 py.to(torch.float32))


def _power(mean2d, conic, px, py):
    dx = mean2d[:, 0:1] - px
    dy = mean2d[:, 1:2] - py
    return (-0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy)
            - conic[:, 1:2] * dx * dy), dx, dy


def _alpha(s: Splats, d: _Dups):
    power, _, _ = _power(s.mean2d[d.gid], s.conic[d.gid], d.px, d.py)
    alpha = torch.clamp(s.opacity[d.gid][:, None] * torch.exp(power),
                        max=ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(ok, alpha, torch.zeros_like(alpha))


def _seg_cumsum(x, seg_start):
    cum = torch.cumsum(x.to(torch.float64), dim=0)
    base = torch.where((seg_start > 0)[:, None],
                       cum[(seg_start - 1).clamp(min=0)],
                       torch.zeros_like(cum[:1]))
    return cum - base


def _seg_exclusive(x, seg_start):
    return torch.clamp(_seg_cumsum(x, seg_start) - x, max=0.0).to(torch.float32)


def _live(alpha, seg_start):
    """The pairs blended: alpha > 0 and before the pixel freezes."""
    log_t = _seg_exclusive(torch.log1p(-alpha), seg_start)
    return (alpha > 0) & ~(torch.exp(log_t) * (1.0 - alpha) < T_EPS)


def split_tiles(img, tiles_x: int, tiles_y: int, tile: int):
    """(H, W, C?) -> (T, tile², C?), zero past the image edge."""
    h, w = img.shape[:2]
    c = tuple(img.shape[2:])
    full = img.new_zeros((tiles_y * tile, tiles_x * tile) + c)
    full[:h, :w] = img
    t = full.reshape((tiles_y, tile, tiles_x, tile) + c).transpose(1, 2)
    return t.reshape((tiles_y * tiles_x, tile * tile) + c)


def assemble(tile_img, tiles_x: int, tiles_y: int, width: int, height: int,
             tile: int):
    """(T, tile², C?) -> (H, W, C?), padding cropped."""
    c = tuple(tile_img.shape[2:])
    img = tile_img.reshape((tiles_y, tiles_x, tile, tile) + c)
    img = img.transpose(1, 2).reshape((tiles_y * tile, tiles_x * tile) + c)
    return img[:height, :width]


class Image(NamedTuple):
    color: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W)
    alpha: torch.Tensor  # (H, W)


class Counts(NamedTuple):
    """A view's blend work: its pixels and tiles, the duplicates up to
    each tile's last blended one (summed over tiles), the blended
    (pixel, duplicate) pairs, the live splats and the duplicates."""

    pixels: int
    tiles: int
    dups_reached: int
    blended: int
    live: int
    dups: int


def blend(s: Splats, b: Binned, width: int, height: int, tile: int,
          lowp: bool = False, counts: bool = False):
    """The view's images (``Image``), and its ``Counts`` when asked."""
    q = rounder(lowp)
    dev = s.depth.device
    n_tiles = b.tile_range.shape[0]
    npix = tile * tile
    color = torch.zeros((n_tiles, npix, 3), device=dev)
    depth = torch.zeros((n_tiles, npix), device=dev)
    total_lg = torch.zeros((n_tiles, npix), device=dev)
    reached = blended = 0
    inside = split_tiles(torch.ones((height, width), device=dev),
                         b.tiles_x, b.tiles_y, tile) > 0
    for tiles in tile_blocks(b):
        if tiles.numel() == 0:
            continue
        d = _duplicates(b, tile, tiles)
        alpha = q(_alpha(s, d))
        log_t = _seg_exclusive(torch.log1p(-alpha), d.seg_start)
        frozen = torch.exp(log_t) * (1.0 - alpha) < T_EPS
        a_hat = torch.where(frozen, torch.zeros_like(alpha), alpha)
        lg = torch.log1p(-a_hat)
        w = q(a_hat * torch.exp(_seg_exclusive(lg, d.seg_start)))
        s_ = d.seg
        color[tiles] = torch.zeros((tiles.shape[0], npix, 3), device=dev) \
            .index_add_(0, s_, w[:, :, None] * s.color[d.gid][:, None, :])
        depth[tiles] = torch.zeros((tiles.shape[0], npix), device=dev) \
            .index_add_(0, s_, w * s.depth[d.gid][:, None])
        total_lg[tiles] = torch.zeros((tiles.shape[0], npix), device=dev) \
            .index_add_(0, s_, lg)
        if counts:
            live = (a_hat > 0) & inside[tiles][s_]
            rank = torch.arange(d.gid.shape[0], device=dev) - d.seg_start + 1
            last = torch.where(live, rank[:, None], torch.zeros_like(live,
                               dtype=torch.int64))
            per_px = torch.zeros((tiles.shape[0], npix), dtype=torch.int64,
                                 device=dev)
            per_px.scatter_reduce_(0, s_[:, None].expand_as(last), last,
                                   "amax")
            reached += int(per_px.amax(dim=1).sum())
            blended += int(live.sum())
    img = lambda x: assemble(x, b.tiles_x, b.tiles_y, width, height, tile)
    out = Image(q(img(color)), q(img(depth)),
                q(img(1.0 - torch.exp(total_lg))))
    if not counts:
        return out
    live_splats = int((s.tiles_touched > 0).sum())
    return out, Counts(pixels=width * height, tiles=n_tiles,
                       dups_reached=reached, blended=blended,
                       live=live_splats, dups=b.total)


class SplatGrads(NamedTuple):
    mean2d: torch.Tensor
    conic: torch.Tensor
    opacity: torch.Tensor
    color: torch.Tensor
    depth: torch.Tensor


def blend_bwd(s: Splats, b: Binned, g_color, g_depth, g_alpha, tile: int,
              lowp: bool = False) -> SplatGrads:
    """Gradients of the blend's inputs from its images' gradients
    (renderCUDA's backward: dL/dα_k = T_k f_k − (S_k − g_A T_N)/(1 − α_k)
    for every blended pair, the 0.99 clamp straight through), over all
    tiles in blocks."""
    q = rounder(lowp)
    dev = s.depth.device
    n = s.depth.shape[0]
    tx, ty = b.tiles_x, b.tiles_y
    gc_t = split_tiles(g_color, tx, ty, tile)
    gd_t = split_tiles(g_depth, tx, ty, tile)
    ga_t = split_tiles(g_alpha, tx, ty, tile)
    acc = {k: torch.zeros((n, c), device=dev)
           for k, c in (("mean2d", 2), ("conic", 3), ("opacity", 1),
                        ("color", 3), ("depth", 1))}
    for tiles in tile_blocks(b):
        if tiles.numel() == 0:
            continue
        d = _duplicates(b, tile, tiles)
        seg, seg_start, g = d.seg, d.seg_start, d.gid
        conic = s.conic[g]
        power, dx, dy = _power(s.mean2d[g], conic, d.px, d.py)
        ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
        gauss = torch.exp(power)
        a_un = s.opacity[g][:, None] * gauss
        alpha = torch.clamp(a_un, max=ALPHA_MAX)
        ok = (power <= 0.0) & (alpha >= ALPHA_MIN)
        alpha = q(torch.where(ok, alpha, torch.zeros_like(alpha)))
        log_t = _seg_exclusive(torch.log1p(-alpha), seg_start)
        live = ok & ~(torch.exp(log_t) * (1.0 - alpha) < T_EPS)
        alpha = torch.where(live, alpha, torch.zeros_like(alpha))
        lg = torch.log1p(-alpha)
        t_k = torch.exp(_seg_exclusive(lg, seg_start))
        t_n = torch.exp(_seg_cumsum(lg, seg_start)[d.seg_end]).to(
            torch.float32)
        w = alpha * t_k
        pick = lambda x: x[tiles][seg]
        gc, gdp = pick(gc_t), pick(gd_t)
        f = (gc * s.color[g][:, None, :]).sum(-1) + gdp * s.depth[g][:, None]
        incl = _seg_cumsum(w * f, seg_start)
        s_k = (incl[d.seg_end] - incl).to(torch.float32)
        dl_da = t_k * f - (s_k - pick(ga_t) * t_n) / (1.0 - alpha)
        zero = torch.zeros_like(dl_da)
        dpower = torch.where(live, a_un * dl_da, zero)
        sp = lambda x: x.sum(dim=1)
        rows = {
            "mean2d": torch.stack([sp(-dpower * (ca * dx + cb * dy)),
                                   sp(-dpower * (cb * dx + cc * dy))], 1),
            "conic": torch.stack([sp(-0.5 * dpower * dx * dx),
                                  sp(-dpower * dx * dy),
                                  sp(-0.5 * dpower * dy * dy)], 1),
            "opacity": sp(torch.where(live, gauss * dl_da, zero))[:, None],
            "color": (w[:, :, None] * gc).sum(dim=1),
            "depth": sp(w * gdp)[:, None],
        }
        for k, r in rows.items():
            acc[k].index_add_(0, g, r)
    return SplatGrads(mean2d=q(acc["mean2d"]), conic=q(acc["conic"]),
                      opacity=q(acc["opacity"][:, 0]), color=q(acc["color"]),
                      depth=q(acc["depth"][:, 0]))


def render(sets: list, cam: Cam, tile: int, lowp: bool = False,
           counts: bool = False, bg: Optional[torch.Tensor] = None):
    """The sets' merged render through ``cam`` (``blend``'s outputs),
    with ``bg`` under the color where given."""
    with torch.no_grad():
        s = join([preprocess(g, cam, tile, lowp) for g in sets])
        b = bin_splats(s, cam.width, cam.height, tile)
        out = blend(s, b, cam.width, cam.height, tile, lowp, counts)
    img, c = out if counts else (out, None)
    if bg is not None:
        img = img._replace(color=img.color + (1.0 - img.alpha)[..., None] * bg)
    return (img, c) if counts else img


def need(sets: list, cam: Cam, tile: int) -> int:
    """The duplicates the view asks for (its ``required_budget``)."""
    with torch.no_grad():
        return int(sum(int(preprocess(g, cam, tile).tiles_touched.sum())
                       for g in sets))
