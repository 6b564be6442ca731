"""Densification (clone / split / prune) in a fixed capacity.

Counterpart of ``autovfx_tpu/train/densify.py`` (itself
``scene/gaussian_model.py:280-417``): clone where the mean screen
gradient is at least the threshold and the splat is small, split (two
children sampled from the parent, scales / 1.6, parent pruned) where it
is large, prune low opacity (and, past the first opacity reset, large
screen radii and world scales), ``reset_opacity`` to at most 0.01.

The store keeps a fixed capacity with an ``active`` mask, as the JAX
package does: candidate i (clones first, then two children per split)
goes into the i-th free slot, the candidates that find none are dropped
and counted in ``dropped``, and nothing waits for the host.  The split
noise comes from an explicit ``torch.Generator``, or from ``noise`` when
a caller needs given numbers (the tests inject JAX's).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS, Gaussians
from autovfx_tpu_torch.core.quaternion import quat_normalize, quat_to_rotmat


@dataclasses.dataclass(frozen=True)
class DensifyStats:
    grad_accum: torch.Tensor  # (N,) f32 sum of screen-gradient norms
    denom: torch.Tensor  # (N,) f32 visibility counts
    max_radii: torch.Tensor  # (N,) int32 largest screen radius seen

    @classmethod
    def zero(cls, capacity: int, device=devices.DEFAULT) -> "DensifyStats":
        device = devices.resolve(device)
        return cls(
            grad_accum=torch.zeros((capacity,), device=device),
            denom=torch.zeros((capacity,), device=device),
            max_radii=torch.zeros((capacity,), dtype=torch.int32,
                                  device=device),
        )

    def update(self, mean2d_grad: torch.Tensor, radii: torch.Tensor,
               width: int, height: int) -> "DensifyStats":
        """Accumulate one view (``add_densification_stats``), in the
        reference's NDC gradient units (see ``scaled_grad_norm``)."""
        visible = radii > 0
        gnorm = scaled_grad_norm(mean2d_grad, width, height)
        return DensifyStats(
            grad_accum=self.grad_accum + torch.where(
                visible, gnorm, torch.zeros_like(gnorm)),
            denom=self.denom + visible.to(torch.float32),
            max_radii=torch.maximum(self.max_radii, radii),
        )


def scaled_grad_norm(mean2d_grad: torch.Tensor, width: int,
                     height: int) -> torch.Tensor:
    """||dL/dmean2D · [W/2, H/2]||: the CUDA backward scales the pixel
    gradient to NDC units (backward.cu:488), and the default threshold
    2e-4 is calibrated to those."""
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=mean2d_grad.device)
    return torch.linalg.norm(mean2d_grad * scale, dim=-1)


class DensifyResult(NamedTuple):
    gaussians: Gaussians
    stats: DensifyStats
    new_mask: torch.Tensor  # (N,) slots (re)written: zero their moments
    n_cloned: torch.Tensor  # () int64
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    dropped: torch.Tensor  # candidates that found no free slot


def _scatter(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """``buf[idx] = val`` where ``mask`` and ``idx < n``; the rest goes to
    a spare slot n that is cut off."""
    n = buf.shape[0]
    idx = torch.where(mask & (idx < n), idx, torch.full_like(idx, n))
    out = torch.cat([buf, buf.new_zeros((1,))])
    return out.scatter(0, idx, val)[:n]


def densify_and_prune(
    g: Gaussians,
    stats: DensifyStats,
    generator: Optional[torch.Generator] = None,
    grad_threshold: float = 0.0002,
    min_opacity: float = 0.005,
    extent: float = 5.0,
    percent_dense: float = 0.01,
    max_screen_size: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
) -> DensifyResult:
    """Clone, split and prune in place of the capacity (a new store).

    ``noise`` (N, 3) standard normals replace the ones drawn from
    ``generator`` (a generator on the CPU or on the Gaussians' device)."""
    n, dev = g.capacity, g.xyz.device
    grads = stats.grad_accum / torch.clamp(stats.denom, min=1.0)
    max_scale = g.scales.amax(dim=-1)

    high_grad = (grads >= grad_threshold) & g.active
    small = max_scale <= percent_dense * extent
    clone_mask = high_grad & small
    split_mask = high_grad & ~small

    prune = g.active & (g.opacity < min_opacity)
    if max_screen_size is not None:
        prune = prune | (g.active & (stats.max_radii > max_screen_size))
        prune = prune | (g.active & (max_scale > 0.1 * extent))
    prune = prune | split_mask  # split parents are replaced by children
    active_after = g.active & ~prune

    # candidates: clones first, then two children per split
    def exclusive_rank(mask):
        m = mask.to(torch.int64)
        return torch.cumsum(m, 0) - m

    clone_rank, split_rank = exclusive_rank(clone_mask), exclusive_rank(split_mask)
    n_clone, n_split = clone_mask.sum(), split_mask.sum()
    n_cand = n_clone + 2 * n_split
    parents = torch.arange(n, device=dev)
    ones = torch.ones((n,), dtype=torch.int64, device=dev)
    cand_parent = torch.zeros((n,), dtype=torch.int64, device=dev)
    cand_kind = torch.zeros((n,), dtype=torch.int64, device=dev)  # 1 = child
    cand_parent = _scatter(cand_parent, clone_rank, parents, clone_mask)
    c0 = n_clone + 2 * split_rank
    for c in (c0, c0 + 1):
        cand_parent = _scatter(cand_parent, c, parents, split_mask)
        cand_kind = _scatter(cand_kind, c, ones, split_mask)

    # the i-th free slot takes candidate i
    free = ~active_after
    free_rank = exclusive_rank(free)
    takes = free & (free_rank < n_cand)
    cand_id = torch.where(takes, torch.clamp(free_rank, max=n - 1),
                          torch.zeros_like(free_rank))
    parent = cand_parent[cand_id]
    is_child = (cand_kind[cand_id] == 1)[:, None]
    src = {f: getattr(g, f)[parent] for f in PARAM_FIELDS}

    if noise is None:
        noise = torch.randn((n, 3), generator=generator,
                            device=generator.device if generator else dev)
    noise = noise.to(device=dev, dtype=torch.float32)
    rot = quat_to_rotmat(quat_normalize(src["quats"]))  # twice, as JAX does
    sample = torch.einsum("nij,nj->ni", rot,
                          torch.exp(src["log_scales"]) * noise)
    src["xyz"] = torch.where(is_child, src["xyz"] + sample, src["xyz"])
    src["log_scales"] = torch.where(
        is_child, src["log_scales"] - float(np.log(0.8 * 2.0)),
        src["log_scales"])

    def put(cur, new):
        m = takes.reshape((-1,) + (1,) * (cur.ndim - 1))
        return torch.where(m, new, cur)

    g2 = Gaussians(**{f: put(getattr(g, f), src[f]) for f in PARAM_FIELDS},
                   active=active_after | takes)
    return DensifyResult(
        gaussians=g2,
        stats=DensifyStats.zero(n, device=dev),
        new_mask=takes | prune,
        n_cloned=n_clone,
        n_split=n_split,
        n_pruned=(prune & g.active).sum(),
        dropped=torch.clamp(n_cand - takes.sum(), min=0),
    )


def reset_opacity(g: Gaussians, ceiling: float = 0.01) -> Gaussians:
    """opacity <- min(opacity, ``ceiling``), as a logit."""
    cap_logit = float(np.log(ceiling / (1 - ceiling)))
    return dataclasses.replace(
        g, opacity_logit=torch.clamp(g.opacity_logit, max=cap_logit))
