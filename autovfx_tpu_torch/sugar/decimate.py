"""Quadric edge-collapse mesh decimation (QEM).

Parity target: o3d ``simplify_quadric_decimation`` used at
``sugar_extractors/coarse_mesh.py:441-458`` (200k/1M-vertex targets).

Vectorized multiple-choice variant: per round, vertex quadrics are
rebuilt from face planes, every edge is scored with the midpoint
quadric error, and a maximal independent set of cheapest edges (no
shared vertices — found with one argsort + first-occurrence masks) is
collapsed at once.  Rounds repeat until the vertex target; this is the
standard parallel-QEM formulation (numpy host-side, like the
reference's o3d call).
"""
from __future__ import annotations

import numpy as np


def _vertex_quadrics(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(V, 4, 4) accumulated fundamental error quadrics."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    n = np.cross(b - a, c - a)
    area = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(area, 1e-12)
    d = -np.sum(n * a, axis=1, keepdims=True)
    p = np.concatenate([n, d], axis=1)  # (F, 4)
    K = (area[:, :, None] * p[:, :, None]) * p[:, None, :]  # area-weighted
    Q = np.zeros((len(verts), 4, 4))
    for k in range(3):
        np.add.at(Q, faces[:, k], K)
    return Q


def _edges_of(faces: np.ndarray) -> np.ndarray:
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    # int64 before the shift: an int32 column shifted by 32 wraps
    e = np.sort(e, axis=1).astype(np.int64)
    # dedupe through a packed int64 key: one 1-D sort instead of the
    # lexicographic row sort np.unique(axis=0) runs (2.5x faster at the
    # 1M-vertex operating point)
    packed = (e[:, 0] << 32) | e[:, 1]
    packed = np.unique(packed)
    return np.stack([packed >> 32, packed & 0xFFFFFFFF], axis=1)


def decimate_quadric(
    verts: np.ndarray,
    faces: np.ndarray,
    target_vertices: int,
    max_rounds: int = 64,
):
    """Collapse edges until <= target_vertices.  Returns (verts, faces)."""
    verts = np.asarray(verts, np.float64).copy()
    faces = np.asarray(faces, np.int64).copy()
    for _ in range(max_rounds):
        if len(verts) <= target_vertices or len(faces) == 0:
            break
        Q = _vertex_quadrics(verts, faces)
        edges = _edges_of(faces)
        if len(edges) == 0:
            break
        mid = 0.5 * (verts[edges[:, 0]] + verts[edges[:, 1]])
        mid_h = np.concatenate([mid, np.ones((len(mid), 1))], axis=1)
        Qe = Q[edges[:, 0]] + Q[edges[:, 1]]
        cost = np.einsum("ei,eij,ej->e", mid_h, Qe, mid_h)

        order = np.argsort(cost)
        se = edges[order]
        # independent set via repeated mutual-first matching: one pass
        # (edge kept iff it is the cheapest edge at BOTH endpoints)
        # collapses only ~8 % of vertices/round; re-matching over the
        # same cost order with matched vertices masked out (no re-sort,
        # no quadric rebuild) lifts that to ~25-30 % and cuts the round
        # count ~3x at the 1M-vertex reference operating point
        budget = max(len(verts) - target_vertices, 0)
        vert_used = np.zeros(len(verts), bool)
        chosen_parts = []
        n_chosen = 0
        for _pass in range(4):
            avail = ~(vert_used[se[:, 0]] | vert_used[se[:, 1]])
            sa = se[avail]
            if len(sa) == 0:
                break
            first_of = np.full(len(verts), -1, np.int64)
            flat = sa.reshape(-1)
            pos = np.repeat(np.arange(len(sa)), 2)
            # reversed so earlier (cheaper) edges overwrite later ones
            first_of[flat[::-1]] = pos[::-1]
            keep = (first_of[sa[:, 0]] == np.arange(len(sa))) & (
                first_of[sa[:, 1]] == np.arange(len(sa))
            )
            kept = sa[keep][: budget - n_chosen]
            if len(kept) == 0:
                break
            chosen_parts.append(kept)
            n_chosen += len(kept)
            if n_chosen >= budget:
                break
            vert_used[kept[:, 0]] = True
            vert_used[kept[:, 1]] = True
        if not chosen_parts:
            break
        chosen = np.concatenate(chosen_parts)

        # collapse b -> a at the midpoint
        a_idx, b_idx = chosen[:, 0], chosen[:, 1]
        verts[a_idx] = 0.5 * (verts[a_idx] + verts[b_idx])
        remap = np.arange(len(verts))
        remap[b_idx] = a_idx
        faces = remap[faces]
        # drop degenerate faces
        good = (
            (faces[:, 0] != faces[:, 1])
            & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2])
        )
        faces = faces[good]
        # compact unused vertices
        used = np.zeros(len(verts), bool)
        used[faces.reshape(-1)] = True
        new_id = np.cumsum(used) - 1
        verts = verts[used]
        faces = new_id[faces]
    return verts.astype(np.float32), faces


def density_quantile_prune(
    verts: np.ndarray,
    faces: np.ndarray,
    densities: np.ndarray,
    quantile: float = 0.1,
):
    """Drop vertices in the lowest density quantile + their faces
    (coarse_mesh.py:441-449: Poisson density prune analog)."""
    if len(verts) == 0:
        return verts, faces
    thr = np.quantile(densities, quantile)
    keep = densities >= thr
    new_id = np.cumsum(keep) - 1
    face_ok = keep[faces].all(axis=1)
    faces = new_id[faces[face_ok]]
    return verts[keep], faces


def remove_small_components(
    verts: np.ndarray,
    faces: np.ndarray,
    min_frac: float = 0.01,
):
    """Drop connected components with < ``min_frac`` of all faces
    (spurious Poisson/TSDF blobs; o3d cluster-removal analog).

    Connectivity via scipy's C connected-components over the edge
    graph — the previous per-face Python union-find took minutes at
    Poisson-384³ mesh sizes."""
    if len(faces) == 0:
        return verts, faces
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = sp.coo_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)),
        shape=(len(verts), len(verts)),
    )
    _, labels = connected_components(adj, directed=False)
    roots = labels[faces[:, 0]]
    counts = np.bincount(roots, minlength=labels.max() + 1)
    face_ok = counts[roots] >= max(min_frac * len(faces), 1)
    faces = faces[face_ok]
    used = np.zeros(len(verts), bool)
    used[faces.reshape(-1)] = True
    new_id = np.cumsum(used) - 1
    return verts[used], new_id[faces]
