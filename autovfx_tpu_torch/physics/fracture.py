"""Voronoi fracture: shatter a mesh into convex debris pieces.

Parity target: ``blender/all_rendering.py:1503-1634`` — the cell-fracture
addon path: break an object into convex-hull rigid bodies with the mass
split among pieces (:1571), triggered either by a 'break' event at a
frame (events table) or by a BVH collision test (:2394-2423).

TPU-first: fracturing is host-side geometry (numpy/scipy Voronoi cells,
like the addon); the debris pieces then run through the same jitted
contact solver as any other bodies.  A fractured edit simulates in two
segments — parent body until the break frame, pieces (inheriting the
parent's pose/velocity + a small radial burst) afterwards.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class FracturePieces(NamedTuple):
    vertices: List[np.ndarray]  # per-piece hull vertices (parent local)
    faces: List[np.ndarray]  # per-piece hull triangle indices
    centers: np.ndarray  # (P, 3) piece centroids (parent local)
    mass_fractions: np.ndarray  # (P,) ∝ hull volume


def fracture_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    num_pieces: int = 8,
    surface_samples: int = 20_000,
    seed: int = 0,
) -> FracturePieces:
    """Voronoi-cell shatter (approximate: cells are hulls of the surface
    samples + interior points owned by each Voronoi seed)."""
    from scipy.spatial import ConvexHull, Delaunay

    rng = np.random.RandomState(seed)
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)

    # dense surface samples (area-weighted)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    p = area / max(area.sum(), 1e-12)
    tri = rng.choice(len(f), size=surface_samples, p=p)
    r1 = np.sqrt(rng.uniform(size=(surface_samples, 1)))
    r2 = rng.uniform(size=(surface_samples, 1))
    surf = (1 - r1) * a[tri] + r1 * (1 - r2) * b[tri] + r1 * r2 * c[tri]

    # interior points + Voronoi seeds via hull rejection sampling
    hull = ConvexHull(v)
    deln = Delaunay(v[hull.vertices])
    lo, hi = v.min(0), v.max(0)
    box = rng.uniform(lo, hi, size=(max(40 * num_pieces, 4000), 3))
    inside = box[deln.find_simplex(box) >= 0]
    if len(inside) < num_pieces:
        inside = np.concatenate([inside, v[hull.vertices]])
    seeds = inside[
        rng.choice(len(inside), num_pieces, replace=False)
    ]

    # assign surface + interior points to nearest seed
    def assign(points):
        d = ((points[:, None] - seeds[None]) ** 2).sum(-1)
        return d.argmin(1)

    surf_cell = assign(surf)
    int_cell = assign(inside)

    pieces, piece_faces, centers, vols = [], [], [], []
    for i in range(num_pieces):
        pts = np.concatenate(
            [surf[surf_cell == i], inside[int_cell == i], seeds[i : i + 1]]
        )
        if len(pts) < 8:
            continue
        try:
            h = ConvexHull(pts)
        except Exception:
            continue
        remap = np.full(len(pts), -1, np.int64)
        remap[h.vertices] = np.arange(len(h.vertices))
        pv = pts[h.vertices]
        pieces.append(pv.astype(np.float32))
        piece_faces.append(remap[h.simplices])
        centers.append(pv.mean(0))
        vols.append(max(h.volume, 1e-12))
    vols = np.asarray(vols)
    return FracturePieces(
        vertices=pieces,
        faces=piece_faces,
        centers=np.asarray(centers, np.float32),
        mass_fractions=(vols / vols.sum()).astype(np.float32),
    )


def burst_velocities(
    pieces: FracturePieces,
    parent_linvel: np.ndarray,
    parent_angvel: np.ndarray,
    parent_com: np.ndarray,
    burst_speed: float = 0.5,
) -> np.ndarray:
    """Debris initial velocities: parent velocity + ω×r + radial burst."""
    r = pieces.centers - parent_com[None]
    radial = r / np.maximum(np.linalg.norm(r, axis=1, keepdims=True), 1e-9)
    return (
        parent_linvel[None]
        + np.cross(np.broadcast_to(parent_angvel, r.shape), r)
        + burst_speed * radial
    ).astype(np.float32)
