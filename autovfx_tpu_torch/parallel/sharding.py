"""Camera data-parallel training and depth-slab sharded rendering.

Counterpart of ``autovfx_tpu/parallel/sharding.py``, written for ranks
of ``torch.distributed`` (``parallel.mesh``): where a JAX function takes
``(D, ...)`` stacked arrays, its counterpart here takes this rank's own
piece (its camera and image, its slab, its stripe of the store), and
where JAX's body uses a collective, this one calls ``parallel.mesh``'s:

  psum -> all_reduce(sum); pmean -> all_reduce(sum) / D;
  pmax / pmin -> all_reduce(max / min); all_gather -> all_gather;
  ppermute -> shift (batch_isend_irecv); all_to_all -> all_to_all;
  axis_index -> Mesh.index.

- ``dp_train_step``: each rank renders its camera and takes its
  gradients; the gradients, loss and PSNR are averaged over ``data``,
  and every rank runs the same Adam update, so the state stays
  replicated.  This parallelizes the dominant cost of 3DGS/SuGaR
  training (the rasterizer's forward and backward).
- ``sharded_render``: the splats are split into view-depth slabs, one
  per rank on ``gauss``; each rank renders its slab to an image and a
  transmittance, and the slabs compose front to back,
  ``C = sum_d C_d prod_{e<d} T_e``, which is exact because a depth
  partition keeps the global per-tile depth order (the reference's
  global sort, rasterizer_impl.cu:304-309, restricted to each slab).
  ``sharded_render_compact`` composes with a log-step scan instead, and
  ``distributed_shard_compact`` builds the slabs from a store that no
  rank holds whole.

Each rank's render is ``ops.rasterize.rasterize``: on the card, kernels
1-3 run in every slab (and kernel 4 and the preprocess backward in every
DP step).  JAX's random camera picks and densify keys cannot be
replayed: ``dp_train`` takes an explicit camera order and a
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core.cameras import Camera, index_camera
from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS, Gaussians
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.parallel import mesh as M
from autovfx_tpu_torch.train import trainer as T
from autovfx_tpu_torch.train.densify import DensifyStats, scaled_grad_norm

_FIELDS = tuple(f.name for f in dataclasses.fields(Gaussians))


# ---- camera data-parallel training ---------------------------------------------


def dp_train_step(
    state: T.TrainState,
    cam: Camera,
    image: torch.Tensor,
    cfg: T.TrainConfig,
    mesh: M.Mesh,
    axis: str = "data",
) -> tuple[T.TrainState, T.StepAux]:
    """One DP step: this rank's camera and target image, the gradients
    averaged over ``axis``, the replicated Adam update.  Returns the new
    state (its tensors updated in place, as ``trainer.train_step`` does)
    and the mean loss and PSNR.

    The densify stats are those of D sequential steps over the same
    cameras: the per-rank NDC gradient *norms* and visibility counts are
    summed (not the norm of a summed gradient), the radii maxed."""
    d = mesh.size(axis)
    loss, (radii, overflow, psnr), grads, offset_grad = T.loss_and_grads(
        state.gaussians, lambda g, offset: T.compute_loss(
            g, offset, cam, image, cfg))
    # one message: every gradient, the loss and the PSNR
    flat = torch.cat([grads[f].reshape(-1) for f in PARAM_FIELDS]
                     + [loss.reshape(1), psnr.detach().reshape(1)])
    flat = M.all_reduce(flat, mesh, axis) / d
    mean, off = {}, 0
    for f in PARAM_FIELDS:
        n = grads[f].numel()
        mean[f] = flat[off:off + n].view_as(grads[f])
        off += n
    g, adam = T.apply_adam(state.gaussians, state.adam, mean, state.step,
                           cfg)
    visible = radii > 0
    gnorm = scaled_grad_norm(offset_grad, cam.width, cam.height)
    counts = M.all_reduce(torch.stack(
        [torch.where(visible, gnorm, torch.zeros_like(gnorm)),
         visible.to(torch.float32)]), mesh, axis)
    radii_max = M.all_reduce(radii.clone(), mesh, axis, "max")
    stats = DensifyStats(
        grad_accum=state.stats.grad_accum + counts[0],
        denom=state.stats.denom + counts[1],
        max_radii=torch.maximum(state.stats.max_radii, radii_max),
    )
    overflow = M.all_reduce(overflow.to(torch.int32).reshape(1), mesh, axis,
                            "max")[0] > 0
    return (T.TrainState(gaussians=g, adam=adam, stats=stats,
                         step=state.step + 1),
            T.StepAux(loss=flat[off].clone(), psnr=flat[off + 1].clone(),
                      overflow=overflow))


def dp_train(
    g: Gaussians,
    cams: Camera,
    images: torch.Tensor,
    cfg: T.TrainConfig,
    mesh: M.Mesh,
    cam_order: np.ndarray,
    generator: Optional[torch.Generator] = None,
    axis: str = "data",
    log_every: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
):
    """The DP training loop: step ``it`` renders camera
    ``cam_order[it - 1, mesh.index(axis)]`` on each rank (``cam_order``
    (iterations, D) ints), with the sequential trainer's densify and
    opacity-reset cadence (train.py:29-188) on the replicated state, and
    periodic checkpoints written by the mesh's first rank.

    ``generator`` (a CPU ``torch.Generator``, seed 0 by default) draws
    densify's split noise; every rank draws the same numbers, so the
    state stays replicated.  Returns the final state and, every
    ``log_every`` steps, the mean loss, PSNR and active count."""
    cam_order = np.asarray(cam_order)
    if cam_order.shape != (cfg.iterations, mesh.size(axis)):
        raise ValueError(f"cam_order must be (iterations, D) = "
                         f"{(cfg.iterations, mesh.size(axis))}, not "
                         f"{cam_order.shape}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    state = T.init_state(g)
    me = mesh.index(axis)
    history = []
    for it in range(1, cfg.iterations + 1):
        ci = int(cam_order[it - 1, me])
        state, aux = dp_train_step(state, index_camera(cams, ci), images[ci],
                                   cfg, mesh, axis)
        if it < cfg.densify_until_iter:
            if (it > cfg.densify_from_iter
                    and it % cfg.densification_interval == 0):
                state, _ = T.densify_step(state, generator, cfg, it)
            if it % cfg.opacity_reset_interval == 0:
                state = T.reset_opacity_step(state)
        if (checkpoint_path and checkpoint_every
                and mesh.rank == mesh.ranks[0]
                and (it % checkpoint_every == 0 or it == cfg.iterations)):
            from autovfx_tpu_torch.train.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_path, state)
        if log_every and it % log_every == 0:
            history.append({"iter": it, "loss": float(aux.loss),
                            "psnr": float(aux.psnr),
                            "active": int(state.gaussians.num_active)})
    return state, history


# ---- depth slabs ------------------------------------------------------------------


def view_depth(xyz: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(N,) view-space z: the last row of ``R @ x + t``."""
    return xyz @ cam.R[2] + cam.t[2]


def assign_depth_slabs(g: Gaussians, cam: Camera,
                       num_slabs: int) -> torch.Tensor:
    """(N,) int32 slab of each splat by view-depth quantile (boundaries
    at the sorted active depths); inactive splats go to slab 0 (they are
    inert)."""
    z = view_depth(g.xyz, cam)
    z_act = torch.where(g.active, z, torch.full_like(z, float("inf")))
    n_act = torch.clamp(g.active.sum(), min=1)
    z_sorted = torch.sort(z_act).values
    qs = torch.arange(1, num_slabs, device=z.device) * n_act // num_slabs
    slab = torch.searchsorted(z_sorted[qs], z, right=True)
    return torch.where(g.active, slab, torch.zeros_like(slab)).to(torch.int32)


def shard_gaussians(g: Gaussians, cam: Camera, num_slabs: int,
                    slab: int) -> Gaussians:
    """Slab ``slab`` of ``num_slabs`` at full capacity: the store with
    only that slab's splats active (exact, no memory win; see
    ``shard_gaussians_compact``)."""
    keep = (assign_depth_slabs(g, cam, num_slabs) == slab) & g.active
    return dataclasses.replace(g, active=keep)


def _window(n: int, start: torch.Tensor, size: int) -> torch.Tensor:
    """``size`` consecutive indices from ``start`` clamped into [0, n -
    size] (``dynamic_slice``'s clamp)."""
    start = torch.clamp(start, 0, n - size)
    return start[..., None] + torch.arange(size, device=start.device)


def shard_gaussians_compact(g: Gaussians, cam: Camera, num_slabs: int,
                            slab: int, slack: float = 0.3):
    """Slab ``slab`` of ``num_slabs`` in ``cap`` ≈ N/D·(1 + slack)
    slots: one stable argsort groups each slab's active members, and
    the slab takes the window of ``cap`` rows from its first one.
    Returns (Gaussians (cap,), overflow ()), ``overflow`` set when a
    depth quantile holds more than ``cap`` active splats (raise
    ``slack``)."""
    n = g.capacity
    cap = min(-(-int(n * (1.0 + slack)) // max(num_slabs, 1)), n)
    slab_of = assign_depth_slabs(g, cam, num_slabs)
    # inactive splats sort to the end of every slab's run
    key = slab_of * 2 + (~g.active).to(torch.int32)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(
        torch.where(g.active, slab_of, torch.full_like(slab_of, num_slabs)),
        minlength=num_slabs + 1)[:num_slabs]
    overflow = torch.any(counts > cap)
    # slab d's active members start where key 2d first appears
    start = torch.searchsorted(key[order].contiguous(),
                               key.new_tensor([2 * slab]))
    idx = order[_window(n, start, cap)[0]]
    live = slab_of[idx] == slab
    out = {f: getattr(g, f)[idx] for f in _FIELDS}
    out["active"] = live & out["active"]
    return Gaussians(**out), overflow


def _slab_pieces(g_local: Gaussians, cam: Camera, config: RasterConfig):
    """This rank's slab rendered: (premultiplied color and depth (4, H,
    W), transmittance (H, W))."""
    out = rasterize(g_local, cam, bg=None, config=config)
    acc = torch.cat([out.color.permute(2, 0, 1), out.depth[None]])
    return acc, 1.0 - out.alpha


def _finish(acc, t_total, bg):
    color = acc[0:3].permute(1, 2, 0)
    if bg is not None:
        color = color + t_total[..., None] * bg
    return color, acc[3], 1.0 - t_total


def sharded_render(
    g_local: Gaussians,
    cam: Camera,
    mesh: M.Mesh,
    config: RasterConfig = RasterConfig(),
    bg: Optional[torch.Tensor] = None,
    axis: str = "gauss",
):
    """The exact composite (color (H, W, 3), depth, alpha), on every
    rank, of the depth slabs on ``axis``: rank d holds slab d (the d-th
    depth quantile, ``shard_gaussians``).  One ``all_gather`` of every
    slab's (5, H, W) image and transmittance."""
    acc, trans = _slab_pieces(g_local, cam, config)
    pieces = M.all_gather(torch.cat([acc, trans[None]])[None], mesh, axis)
    acc_d, trans_d = pieces[:, :4], pieces[:, 4]
    # front-to-back over-composite across slabs
    t_before = torch.cat([torch.ones_like(trans_d[:1]),
                          torch.cumprod(trans_d, dim=0)[:-1]])
    acc = torch.sum(acc_d * t_before[:, None], dim=0)
    return _finish(acc, torch.prod(trans_d, dim=0), bg)


def sharded_render_compact(
    g_local: Gaussians,
    cam: Camera,
    mesh: M.Mesh,
    config: RasterConfig = RasterConfig(),
    bg: Optional[torch.Tensor] = None,
    axis: str = "gauss",
):
    """The depth-slab composite by a log-step scan (no all_gather).

    The front-to-back over-composite is associative,
        (A1, T1) ⊕ (A2, T2) = (A1 + T1·A2, T1·T2),
    so a Hillis–Steele inclusive scan over the ranks (log₂ D ``shift``
    hops of one (5, H, W) message each) leaves the whole composite on
    the last rank, which broadcasts it.  Each rank holds one image stack,
    not D."""
    d_count, me = mesh.size(axis), mesh.index(axis)
    acc, trans = _slab_pieces(g_local, cam, config)
    step = 1
    while step < d_count:
        # the inclusive prefix of the rank ``step`` places in front
        # (lower slab index = nearer the camera)
        front = M.shift(torch.cat([acc, trans[None]]), mesh, axis, step)
        if front is not None:
            acc = front[:4] + front[4] * acc
            trans = front[4] * trans
        step *= 2
    whole = M.broadcast(torch.cat([acc, trans[None]]), mesh, axis,
                        d_count - 1)
    return _finish(whole[:4], whole[4], bg)


# ---- distributed slab build (no rank holds the whole store) ---------------------


def _pack_feature_matrix(g: Gaussians) -> torch.Tensor:
    """(M, F) float32 rows: xyz | sh_dc | sh_rest | log_scales | quats |
    opacity | active, the exchange currency of the distributed build."""
    m = g.capacity
    return torch.cat([g.xyz, g.sh_dc, g.sh_rest.reshape(m, -1), g.log_scales,
                      g.quats, g.opacity_logit[:, None],
                      g.active.to(torch.float32)[:, None]], dim=-1)


def _unpack_feature_matrix(feat: torch.Tensor, sh_rest_k: int) -> Gaussians:
    widths = (3, 3, 3 * sh_rest_k, 3, 4, 1, 1)
    # the kernels read contiguous fields, not column slices of the rows
    xyz, sh_dc, sh_rest, log_scales, quats, opacity, active = (
        x.contiguous() for x in torch.split(feat, widths, dim=-1))
    active = active[:, 0] > 0.5
    # zeroed (inactive) exchange rows: identity quaternion and opacity
    # logit -10, so no 0/0 reaches the covariance before culling masks it
    quats = torch.where(active[:, None], quats, torch.zeros_like(quats))
    quats[:, 0] += torch.where(active, 0.0, 1.0)
    opacity = torch.where(active, opacity[:, 0],
                          torch.full_like(opacity[:, 0], -10.0))
    return Gaussians(xyz=xyz, sh_dc=sh_dc,
                     sh_rest=sh_rest.reshape(-1, sh_rest_k, 3),
                     log_scales=log_scales, quats=quats,
                     opacity_logit=opacity, active=active)


def distributed_shard_compact(
    g_local: Gaussians,
    cam: Camera,
    mesh: M.Mesh,
    axis: str = "gauss",
    slack: float = 0.3,
    bins: int = 512,
):
    """This rank's depth slab, built from its stripe ``g_local`` (M,)
    of a store that no rank holds whole (``round_robin_store``).

    The global depth range (min / max over ``axis``) and a 512-bin
    depth histogram (summed over ``axis``) give the slab boundaries at
    count quantiles; each rank then routes its splats to their slab's
    rank in ONE ``all_to_all`` of (D, cap/D) packed feature blocks.
    Returns (Gaussians (D · cap/D,), overflow ()): ``overflow`` is set,
    on every rank, when one (source, destination) pair exceeds its block
    (raise ``slack`` for a depth-clustered store)."""
    d_count = mesh.size(axis)
    m = g_local.capacity
    cap_pair = -(-int(m * (1.0 + slack)) // d_count)
    cap_pair = max(-(-cap_pair // 8) * 8, 8)
    sh_rest_k = g_local.sh_rest.shape[1]
    z = view_depth(g_local.xyz, cam)
    act = g_local.active
    inf = torch.full_like(z, float("inf"))
    lo = M.all_reduce(torch.where(act, z, inf).min().reshape(1), mesh, axis,
                      "min")[0]
    hi = M.all_reduce(torch.where(act, z, -inf).max().reshape(1), mesh,
                      axis, "max")[0]
    span = torch.clamp(hi - lo, min=1e-6)
    # global depth histogram -> slab boundaries at count quantiles
    bin_of = torch.clamp(((z - lo) / span * bins).to(torch.int32), 0,
                         bins - 1)
    hist = torch.bincount(bin_of[act], minlength=bins).to(torch.int32)
    hist = M.all_reduce(hist, mesh, axis)
    n_act = torch.clamp(hist.sum(), min=1)
    cum = torch.cumsum(hist, 0)
    # boundary k = first bin where cum >= (k + 1) n / D
    targets = torch.arange(1, d_count, device=z.device) * n_act // d_count
    bounds = torch.searchsorted(cum, targets.to(cum.dtype))
    slab = torch.searchsorted(bounds, bin_of.to(bounds.dtype), right=True)
    slab = torch.where(act, slab, torch.full_like(slab, d_count))

    feat = _pack_feature_matrix(g_local)
    # a stable argsort groups each destination contiguously (inactive
    # splats carry slab D and sort to the tail); order within a slab is
    # irrelevant, since the renderer sorts by depth
    order = torch.argsort(slab, stable=True)
    slab_sorted, feat_sorted = slab[order], feat[order]
    del feat  # a rank holds at most two copies of its rows at a time
    rows = max(m, cap_pair)  # a window never runs past the rows
    if rows > m:
        slab_sorted = torch.cat([slab_sorted,
                                 slab_sorted.new_full((rows - m,), d_count)])
        feat_sorted = torch.cat([feat_sorted,
                                 feat_sorted.new_zeros(
                                     (rows - m, feat_sorted.shape[1]))])
    dst = torch.arange(d_count, device=z.device)
    start = torch.searchsorted(slab_sorted, dst)
    count = torch.searchsorted(slab_sorted, dst, right=True) - start
    pair_overflow = torch.any(count > cap_pair)
    win = _window(rows, start, cap_pair)  # (D, cap_pair)
    live = (slab_sorted[win] == dst[:, None]).to(feat_sorted.dtype)
    send = feat_sorted[win] * live[..., None]  # (D, cap_pair, F)
    del feat_sorted
    recv = M.all_to_all(send.reshape(d_count * cap_pair, -1), mesh, axis)
    del send
    ovf = M.all_reduce(pair_overflow.to(torch.int32).reshape(1), mesh, axis,
                       "max")[0] > 0
    return _unpack_feature_matrix(recv, sh_rest_k), ovf


def round_robin_store(g: Gaussians, num_devices: int, rank: int) -> Gaussians:
    """Rank ``rank``'s stripe of the (D, M) store a flat scene loads into:
    rows ``[rank M, (rank + 1) M)`` of the scene padded to D·M slots (on
    a cluster each rank would load only its own stripe from disk)."""
    n = g.capacity
    m = -(-n // num_devices)
    g = g.pad_to(m * num_devices)
    return Gaussians(**{f: getattr(g, f)[rank * m:(rank + 1) * m]
                        for f in _FIELDS})


def sharded_render_trajectory(
    g_local: Gaussians,
    cams: Camera,
    num_frames: int,
    mesh: M.Mesh,
    config: RasterConfig = RasterConfig(),
    bg: Optional[torch.Tensor] = None,
    axis: str = "gauss",
    slack: float = 0.3,
    reshard_translation: float = 0.25,
    reshard_cos: float = 0.97,
):
    """Render a trajectory from this rank's store stripe, building the
    slabs again only when needed.

    Slabs are built at an ANCHOR camera (with ``slack`` headroom); later
    frames reuse them until the camera moves more than
    ``reshard_translation`` × the scene radius, its view direction turns
    past ``reshard_cos``, or the build overflowed (then it is built once
    more at doubled slack).  Returns (frames (F, H, W, 3) on every rank,
    the number of builds)."""
    radius = float(M.all_reduce(
        torch.linalg.norm(g_local.xyz, dim=-1).max().reshape(1), mesh, axis,
        "max")[0])
    anchor, slabs, frames, reshards = None, None, [], 0
    for f in range(num_frames):
        cam = index_camera(cams, f)
        need = slabs is None
        if not need:
            t_move = float(torch.linalg.norm(cam.center - anchor.center))
            cosang = float(torch.dot(cam.R[2], anchor.R[2]))
            need = (t_move > reshard_translation * radius
                    or cosang < reshard_cos)
        if need:
            slabs, ovf = distributed_shard_compact(g_local, cam, mesh,
                                                   axis=axis, slack=slack)
            if bool(ovf):
                # one retry with doubled slack (still never O(N) a rank)
                slabs, ovf = distributed_shard_compact(
                    g_local, cam, mesh, axis=axis, slack=2 * slack + 0.3)
            anchor = cam
            reshards += 1
        color, _, _ = sharded_render_compact(slabs, cam, mesh, config=config,
                                             bg=bg, axis=axis)
        frames.append(color)
    return torch.stack(frames), reshards
