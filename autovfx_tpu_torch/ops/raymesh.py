"""Batched first-hit ray-mesh intersection.

Counterpart of ``autovfx_tpu/ops/raymesh.py``: Möller-Trumbore over all
(ray, triangle) pairs, one chunk of triangles at a time, with a running
nearest-hit reduction; no BVH.  The ties between triangles of one chunk
go to the lowest index, and a later chunk wins only when strictly
nearer, as in the reference.
"""
from __future__ import annotations

import torch

EPS = 1e-9
NO_HIT = 1e30


def ray_mesh_first_hit(
    origins: torch.Tensor,  # (R, 3)
    dirs: torch.Tensor,  # (R, 3)
    tri_a: torch.Tensor,  # (T, 3)
    tri_b: torch.Tensor,
    tri_c: torch.Tensor,
    tri_chunk: int = 4096,
):
    """Returns (t (R,), tri_index (R,) int64, -1 on a miss, hit (R,) bool);
    t is 1e30 on a miss."""
    n_rays, t_count = origins.shape[0], tri_a.shape[0]
    best_t = origins.new_full((n_rays,), NO_HIT)
    best_i = torch.full((n_rays,), -1, dtype=torch.int64,
                        device=origins.device)
    d = dirs[:, None, :]
    for s in range(0, t_count, tri_chunk):
        a, b, c = (x[s:s + tri_chunk] for x in (tri_a, tri_b, tri_c))
        e1 = b - a  # (C, 3)
        e2 = c - a
        pvec = torch.linalg.cross(d.expand(-1, e2.shape[0], -1),
                                  e2[None].expand(n_rays, -1, -1), dim=-1)
        det = torch.sum(e1[None] * pvec, -1)  # (R, C)
        ok_det = torch.abs(det) > EPS
        inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
        tvec = origins[:, None, :] - a[None]
        u = torch.sum(tvec * pvec, -1) * inv_det
        qvec = torch.linalg.cross(tvec, e1[None].expand(n_rays, -1, -1),
                                  dim=-1)
        v = torch.sum(d * qvec, -1) * inv_det
        t = torch.sum(e2[None] * qvec, -1) * inv_det
        ok = ok_det & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
        t = torch.where(ok, t, torch.full_like(t, NO_HIT))
        local_best, local_idx = torch.min(t, dim=1)
        better = local_best < best_t
        best_t = torch.where(better, local_best, best_t)
        best_i = torch.where(better, local_idx + s, best_i)
    hit = best_t < NO_HIT
    best_i = torch.where(hit, best_i, torch.full_like(best_i, -1))
    return best_t, best_i, hit
