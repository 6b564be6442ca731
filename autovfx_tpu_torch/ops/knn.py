"""Approximate k-nearest neighbours by Morton-order windows.

Counterpart of ``autovfx_tpu/ops/knn.py`` (itself the skeleton of
``simple-knn``'s ``distCUDA2``): quantize to a 2^10 grid, interleave to
30-bit Morton codes, stable-sort by code, and take each point's
candidates from the ±``window`` neighbours in that order.  Plain
tensor code: an argsort, a window gather and a top-k, used once at
initialization.  Inactive points (``mask`` False) sort last and neither
query nor serve as neighbours.

Morton codes are int64 here (the JAX package uses uint32); every value
stays below 2^32, so the codes and their order are the same.
"""
from __future__ import annotations

from typing import Optional

import torch

_INACTIVE_CODE = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every third position.  Each mask keeps the low
    32 bits, so the int64 products give the uint32 results."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(xyz: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 3) points -> (N,) int64 Morton codes on the active bounding box."""
    if mask is None:
        mask = torch.ones(xyz.shape[:1], dtype=torch.bool, device=xyz.device)
    big = 1e30
    m = mask[:, None]
    lo = torch.where(m, xyz, torch.full_like(xyz, big)).amin(dim=0)
    hi = torch.where(m, xyz, torch.full_like(xyz, -big)).amax(dim=0)
    extent = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp(((xyz - lo) / extent) * 1023.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def _window(xyz, mask, offsets):
    """Sorted order, and the squared distances (N, len(offsets)) to each
    point's window candidates in Morton order (+inf where not a valid
    candidate); ``idx_c`` are the candidates' sorted positions."""
    n = xyz.shape[0]
    dev = xyz.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    codes = torch.where(mask, morton_codes(xyz, mask),
                        torch.full((n,), _INACTIVE_CODE, device=dev))
    order = torch.argsort(codes, stable=True)
    pts = xyz[order]
    act = mask[order]
    idx = torch.arange(n, device=dev)[:, None] + offsets[None, :]
    in_range = (idx >= 0) & (idx < n)
    idx_c = torch.clamp(idx, 0, n - 1)
    ok = in_range & act[idx_c] & act[:, None]
    d2 = torch.sum((pts[idx_c] - pts[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    return order, act, idx_c, d2


def mean_knn_dist2(
    xyz: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    k: int = 3,
    window: int = 32,
) -> torch.Tensor:
    """(N,) mean squared distance to the k nearest neighbours (``distCUDA2``);
    0 for inactive points."""
    dev = xyz.device
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])
    order, act, _, d2 = _window(xyz, mask, offs)
    top = torch.topk(d2, k, dim=1, largest=False).values
    valid = torch.isfinite(top)
    mean = (torch.where(valid, top, torch.zeros_like(top)).sum(dim=-1)
            / torch.clamp(valid.sum(dim=-1), min=1))
    mean = torch.where(act, mean, torch.zeros_like(mean))
    out = torch.zeros_like(mean)
    out[order] = mean
    return out


def knn_indices(
    xyz: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    k: int = 16,
    window: int = 48,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, k) int64 neighbour indices and squared distances, nearest
    first; the window includes the point itself (SuGaR's ``knn_points``
    semantics).  Inactive points get self-indices and +inf distances.

    The k smallest come from a stable sort rather than ``topk``, so that
    equal distances keep the lower window position first, as the JAX
    ``top_k`` does."""
    n = xyz.shape[0]
    dev = xyz.device
    order, _, idx_c, d2 = _window(
        xyz, mask, torch.arange(-window, window + 1, device=dev))
    top_d2, top_pos = torch.sort(d2, dim=1, stable=True)
    top_d2, top_pos = top_d2[:, :k], top_pos[:, :k]
    nbr = order[torch.gather(idx_c, 1, top_pos)]
    nbr = torch.where(torch.isfinite(top_d2), nbr, order[:, None].expand(n, k))
    out_idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    out_d2 = torch.full((n, k), float("inf"), device=dev)
    out_idx[order] = nbr
    out_d2[order] = top_d2
    return out_idx, out_d2
