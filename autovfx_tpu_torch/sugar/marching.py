"""Iso-surface triangulation via marching tetrahedra (numpy, host-side).

Replaces the reference's Open3D Poisson reconstruction / marching-cubes
alternative (``sugar_extractors/coarse_mesh.py`` :398-409 Poisson,
:725-764 marching cubes) — Open3D is not available in this environment,
and marching tetrahedra has a tiny, easily-verified case table while
producing an equivalent surface from the density grid.  Each grid cube
splits into 6 tetrahedra; each tet with a mixed in/out sign pattern
emits 1–2 triangles with linear edge interpolation.

A copy of ``autovfx_tpu/sugar/marching.py`` (numpy only, host-side):
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

# 6 tetrahedra per cube (indices into the 8 cube corners), a standard
# diagonal decomposition sharing the 0-7 main diagonal
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    np.int64,
)

# cube corner offsets (z fastest): corner i = (x+(i&1), y+((i>>1)&1), z+(i>>2))
_CORNERS = np.array(
    [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int64
)

# tet edge list (pairs of local tet vertices 0..3)
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64
)

# triangulation per 4-bit sign case: indices into _TET_EDGES, -1 padded.
# case bit i set <=> tet vertex i is inside (value >= level).
_TET_TRIS = -np.ones((16, 2, 3), np.int64)
_TET_TRIS[0b0001] = [[0, 1, 2], [-1, -1, -1]]
_TET_TRIS[0b1110] = [[0, 2, 1], [-1, -1, -1]]
_TET_TRIS[0b0010] = [[0, 4, 3], [-1, -1, -1]]
_TET_TRIS[0b1101] = [[0, 3, 4], [-1, -1, -1]]
_TET_TRIS[0b0100] = [[1, 3, 5], [-1, -1, -1]]
_TET_TRIS[0b1011] = [[1, 5, 3], [-1, -1, -1]]
_TET_TRIS[0b1000] = [[2, 5, 4], [-1, -1, -1]]
_TET_TRIS[0b0111] = [[2, 4, 5], [-1, -1, -1]]
_TET_TRIS[0b0011] = [[1, 4, 3], [1, 2, 4]]
_TET_TRIS[0b1100] = [[1, 3, 4], [1, 4, 2]]
_TET_TRIS[0b0101] = [[0, 3, 5], [0, 5, 2]]
_TET_TRIS[0b1010] = [[0, 5, 3], [0, 2, 5]]
_TET_TRIS[0b0110] = [[0, 4, 5], [0, 5, 1]]
_TET_TRIS[0b1001] = [[0, 5, 4], [0, 1, 5]]


def marching_tetrahedra(
    grid: np.ndarray, level: float, origin, spacing
) -> tuple[np.ndarray, np.ndarray]:
    """Triangulate the ``level`` iso-surface of a (X, Y, Z) scalar grid.

    Returns (vertices (V, 3), faces (F, 3)); duplicate vertices are merged.
    """
    grid = np.asarray(grid, np.float32)
    nx, ny, nz = grid.shape
    origin = np.asarray(origin, np.float64)
    spacing = np.asarray(
        spacing if np.ndim(spacing) else [spacing] * 3, np.float64
    )

    # corner values for every cube: (nx-1, ny-1, nz-1, 8)
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    corner_vals = np.empty((cx, cy, cz, 8), np.float32)
    for i, (dx, dy, dz) in enumerate(_CORNERS):
        corner_vals[..., i] = grid[dx : cx + dx, dy : cy + dy, dz : cz + dz]

    # cubes crossed by the surface
    vmin = corner_vals.min(-1)
    vmax = corner_vals.max(-1)
    cube_idx = np.argwhere((vmin < level) & (vmax >= level))
    if len(cube_idx) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    cvals = corner_vals[cube_idx[:, 0], cube_idx[:, 1], cube_idx[:, 2]]
    cpos = cube_idx[:, None, :] + _CORNERS[None, :, :]  # (Ncube, 8, 3)

    tris = []
    for tet in _TETS:
        tvals = cvals[:, tet]  # (Ncube, 4)
        tpos = cpos[:, tet]  # (Ncube, 4, 3)
        case = (
            (tvals[:, 0] >= level).astype(np.int64)
            | ((tvals[:, 1] >= level).astype(np.int64) << 1)
            | ((tvals[:, 2] >= level).astype(np.int64) << 2)
            | ((tvals[:, 3] >= level).astype(np.int64) << 3)
        )
        active = (case != 0) & (case != 15)
        if not active.any():
            continue
        case_a = case[active]
        tv = tvals[active]
        tp = tpos[active].astype(np.float64)

        # interpolated point on each of the 6 tet edges
        e0 = _TET_EDGES[:, 0]
        e1 = _TET_EDGES[:, 1]
        v0 = tv[:, e0]
        v1 = tv[:, e1]
        denom = np.where(np.abs(v1 - v0) > 1e-12, v1 - v0, 1.0)
        t = np.clip((level - v0) / denom, 0.0, 1.0)  # (Na, 6)
        p_edge = tp[:, e0] + t[..., None] * (tp[:, e1] - tp[:, e0])

        tri_edges = _TET_TRIS[case_a]  # (Na, 2, 3)
        for s in range(2):
            te = tri_edges[:, s]
            ok = te[:, 0] >= 0
            if not ok.any():
                continue
            pe = p_edge[ok]
            tri = np.stack(
                [
                    pe[np.arange(ok.sum()), te[ok, 0]],
                    pe[np.arange(ok.sum()), te[ok, 1]],
                    pe[np.arange(ok.sum()), te[ok, 2]],
                ],
                axis=1,
            )
            tris.append(tri)

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri_pts = np.concatenate(tris)  # (F, 3, 3) in grid coords

    # merge duplicate vertices (quantized to 1e-5 grid units)
    flat = tri_pts.reshape(-1, 3)
    keyq = np.round(flat * 1e5).astype(np.int64)
    uniq, inv = np.unique(keyq, axis=0, return_inverse=True)
    verts_grid = np.zeros((len(uniq), 3), np.float64)
    verts_grid[inv] = flat
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    keep = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[keep]
    verts = (origin[None] + verts_grid * spacing[None]).astype(np.float32)
    return verts, faces.astype(np.int64)


def decimate_vertex_clustering(
    vertices: np.ndarray, faces: np.ndarray, target_vertices: int
) -> tuple[np.ndarray, np.ndarray]:
    """Simple vertex-clustering decimation (replaces Open3D quadric
    decimation, coarse_mesh.py:441-458 — coarser but dependency-free)."""
    if len(vertices) <= target_vertices:
        return vertices, faces
    lo = vertices.min(0)
    hi = vertices.max(0)
    extent = np.maximum(hi - lo, 1e-9)
    # pick grid resolution so expected occupied cells ≈ target
    res = 16
    while res < 4096:
        cell = extent.max() / res
        key = np.floor((vertices - lo) / cell).astype(np.int64)
        uniq = np.unique(key, axis=0)
        if len(uniq) >= target_vertices:
            break
        res *= 2
    keys = (
        key[:, 0] * 4_000_000_000_000 + key[:, 1] * 2_000_000 + key[:, 2]
    )
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    new_v = np.zeros((len(uniq_keys), 3), np.float64)
    cnt = np.zeros(len(uniq_keys))
    np.add.at(new_v, inv, vertices)
    np.add.at(cnt, inv, 1)
    new_v /= cnt[:, None]
    new_f = inv[faces]
    keep = (
        (new_f[:, 0] != new_f[:, 1])
        & (new_f[:, 1] != new_f[:, 2])
        & (new_f[:, 0] != new_f[:, 2])
    )
    return new_v.astype(np.float32), new_f[keep]
