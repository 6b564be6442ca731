"""Collision shapes: convex hulls and a uniform grid over the scene mesh.

Counterpart of ``autovfx_tpu/physics/shapes.py``.  Hulls are padded
(``max_verts`` vertices, ``max_faces`` planes) so contact generation is
fixed-shape tensor math; the scene mesh is bucketed into a uniform grid
on the host and queried on the device by gathering each cell's
candidate triangles.  The host builds (scipy's ``ConvexHull``, the
bucketing loops) are copies of the reference's and give equal arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.utils.gather import take


class ConvexHullShape(NamedTuple):
    """Padded convex hulls (body frame, about the center of mass)."""

    verts: torch.Tensor  # (B, Vmax, 3)
    vert_mask: torch.Tensor  # (B, Vmax)
    planes: torch.Tensor  # (B, Fmax, 4)  n·x <= d, outward normals
    plane_mask: torch.Tensor  # (B, Fmax)
    radius: torch.Tensor  # (B,) bounding-sphere radius


def build_hulls(meshes_vertices: list, max_verts: int = 64,
                max_faces: int = 64, device=devices.DEFAULT):
    """scipy convex hulls of each vertex set, decimated to the padded
    budgets.  Returns (ConvexHullShape on ``device``, coms (B, 3),
    volumes (B,), unit-mass inertias (B, 3, 3)), the last three numpy,
    the vertices about the center of mass (uniform density)."""
    from scipy.spatial import ConvexHull

    device = devices.resolve(device)
    b = len(meshes_vertices)
    verts = np.zeros((b, max_verts, 3), np.float32)
    vmask = np.zeros((b, max_verts), bool)
    planes = np.zeros((b, max_faces, 4), np.float32)
    pmask = np.zeros((b, max_faces), bool)
    radius = np.zeros((b,), np.float32)
    coms = np.zeros((b, 3), np.float32)
    vols = np.zeros((b,), np.float32)
    inertias = np.zeros((b, 3, 3), np.float32)

    for i, pts in enumerate(meshes_vertices):
        pts = np.asarray(pts, np.float64)
        hull = ConvexHull(pts)
        com, vol, inertia = _hull_mass_properties(
            pts[hull.vertices], hull.points, hull.simplices)
        coms[i] = com
        vols[i] = vol
        inertias[i] = inertia
        v = pts[hull.vertices] - com
        if len(v) > max_verts:  # farthest points keep the silhouette
            v = _farthest_points(v, max_verts)
        verts[i, : len(v)] = v
        vmask[i, : len(v)] = True
        eq = ConvexHull(v).equations  # (F, 4): n·x + c <= 0
        if len(eq) > max_faces:
            eq = eq[_diverse_planes(eq, max_faces)]
        planes[i, : len(eq), :3] = eq[:, :3]
        planes[i, : len(eq), 3] = -eq[:, 3]
        pmask[i, : len(eq)] = True
        radius[i] = np.linalg.norm(v, axis=1).max()

    t = lambda a: torch.tensor(a, device=device)
    shape = ConvexHullShape(verts=t(verts), vert_mask=t(vmask),
                            planes=t(planes), plane_mask=t(pmask),
                            radius=t(radius))
    return shape, coms, vols, inertias


def _hull_mass_properties(hull_pts, all_pts, simplices):
    """Uniform-density COM and volume by tetrahedra; unit-mass inertia by
    seeded sampling (good to ~1 %)."""
    ref = hull_pts.mean(axis=0)
    com = np.zeros(3)
    vol = 0.0
    for tri in simplices:
        a = all_pts[tri[0]] - ref
        b_ = all_pts[tri[1]] - ref
        c = all_pts[tri[2]] - ref
        v = abs(np.dot(a, np.cross(b_, c))) / 6.0
        com += v * (a + b_ + c) / 4.0
        vol += v
    com = ref + (com / max(vol, 1e-12))
    rng = np.random.RandomState(0)
    lo, hi = hull_pts.min(0), hull_pts.max(0)
    samples = rng.uniform(lo, hi, size=(8192, 3))
    from scipy.spatial import Delaunay

    inside = Delaunay(hull_pts).find_simplex(samples) >= 0
    pts_in = samples[inside] - com
    if len(pts_in) < 16:
        pts_in = hull_pts - com
    r2 = (pts_in**2).sum(1)
    inertia = (r2[:, None, None] * np.eye(3)
               - pts_in[:, :, None] * pts_in[:, None, :]).mean(0)
    return com, vol, inertia.astype(np.float32)


def _farthest_points(v, k):
    sel = [int(np.argmax(np.linalg.norm(v, axis=1)))]
    d = np.linalg.norm(v - v[sel[0]], axis=1)
    for _ in range(k - 1):
        i = int(np.argmax(d))
        sel.append(i)
        d = np.minimum(d, np.linalg.norm(v - v[i], axis=1))
    return v[sel]


def _diverse_planes(eq, k):
    n = eq[:, :3]
    sel = [0]
    score = 1.0 - n @ n[0]
    for _ in range(k - 1):
        i = int(np.argmax(score))
        sel.append(i)
        score = np.minimum(score, 1.0 - n @ n[i])
    return np.array(sel)


# ---- the static scene-mesh collider ------------------------------------------


class MeshGrid(NamedTuple):
    """Uniform-grid bucketing of the scene mesh's triangles."""

    tri_a: torch.Tensor  # (T, 3)
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    tri_n: torch.Tensor  # (T, 3) unit normals
    cell_tris: torch.Tensor  # (C, M) int64 triangle ids per cell, -1 pad
    origin: torch.Tensor  # (3,)
    cell_size: torch.Tensor  # ()
    dims: tuple  # (nx, ny, nz)


def build_mesh_grid(
    vertices: np.ndarray,
    faces: np.ndarray,
    resolution: int = 48,
    max_per_cell: int = 64,
    device=devices.DEFAULT,
) -> MeshGrid:
    """Bucket triangles into a uniform grid by their bounds, grown by one
    cell so that points penetrating from a neighboring cell still see
    the triangle; a cell keeps its first ``max_per_cell``."""
    device = devices.resolve(device)
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(b - a, c - a)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

    lo = v.min(0) - 1e-3
    hi = v.max(0) + 1e-3
    extent = hi - lo
    cell = float(extent.max()) / resolution
    dims = np.maximum(np.ceil(extent / cell).astype(int), 1)
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    n_cells = nx * ny * nz

    cell_lists = [[] for _ in range(n_cells)]
    tmin = np.floor((np.minimum(np.minimum(a, b), c) - lo) / cell).astype(int) - 1
    tmax = np.floor((np.maximum(np.maximum(a, b), c) - lo) / cell).astype(int) + 1
    tmin = np.clip(tmin, 0, dims - 1)
    tmax = np.clip(tmax, 0, dims - 1)
    for t in range(len(f)):
        for ix in range(tmin[t, 0], tmax[t, 0] + 1):
            for iy in range(tmin[t, 1], tmax[t, 1] + 1):
                for iz in range(tmin[t, 2], tmax[t, 2] + 1):
                    idx = (ix * ny + iy) * nz + iz
                    if len(cell_lists[idx]) < max_per_cell:
                        cell_lists[idx].append(t)

    cell_tris = -np.ones((n_cells, max_per_cell), np.int64)
    for i, lst in enumerate(cell_lists):
        cell_tris[i, : len(lst)] = lst

    t = lambda x: torch.tensor(x, device=device)
    return MeshGrid(tri_a=t(a), tri_b=t(b), tri_c=t(c), tri_n=t(n),
                    cell_tris=t(cell_tris), origin=t(lo),
                    cell_size=t(np.float32(cell)), dims=(nx, ny, nz))


def closest_point_on_triangle(p, a, b, c):
    """Ericson's closest point on triangle (a, b, c) to p, branch-free."""
    dot = lambda x, y: torch.sum(x * y, -1)
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    one = torch.ones_like(d1)
    nonzero = lambda x: torch.where(x != 0, x, one)
    denom_bc = (d4 - d3) + (d5 - d6)
    w_bc = torch.clamp((d4 - d3) / nonzero(denom_bc), 0, 1)

    denom = nonzero(va + vb + vc)
    v = vb / denom
    w = vc / denom
    pt_face = a + v[..., None] * ab + w[..., None] * ac

    t_ab = torch.clamp(d1 / nonzero(d1 - d3), 0, 1)
    pt_ab = a + t_ab[..., None] * ab
    t_ac = torch.clamp(d2 / nonzero(d2 - d6), 0, 1)
    pt_ac = a + t_ac[..., None] * ac
    pt_bc = b + w_bc[..., None] * (c - b)

    cond_a = (d1 <= 0) & (d2 <= 0)
    cond_b = (d3 >= 0) & (d4 <= d3)
    cond_c = (d6 >= 0) & (d5 <= d6)
    cond_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    cond_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    cond_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    pt = pt_face
    pt = torch.where(cond_bc[..., None], pt_bc, pt)
    pt = torch.where(cond_ac[..., None], pt_ac, pt)
    pt = torch.where(cond_ab[..., None], pt_ab, pt)
    pt = torch.where(cond_c[..., None], c.expand_as(pt), pt)
    pt = torch.where(cond_b[..., None], b.expand_as(pt), pt)
    pt = torch.where(cond_a[..., None], a.expand_as(pt), pt)
    return pt


def _candidates(grid: MeshGrid, points: torch.Tensor):
    """Each point's cell's candidate triangles: (ids (P, M) clamped to
    0, valid (P, M), closest points (P, M, 3), distances (P, M), inf
    where invalid)."""
    nx, ny, nz = grid.dims
    rel = (points - grid.origin) / grid.cell_size
    ci = rel.to(torch.int32)  # truncates toward zero, then clamps
    cx, cy, cz = (torch.clamp(ci[:, k], 0, n - 1)
                  for k, n in enumerate((nx, ny, nz)))
    flat = (cx.long() * ny + cy) * nz + cz
    cand = take(grid.cell_tris, flat)
    valid = cand >= 0
    cand_c = torch.clamp(cand, min=0)
    cp = closest_point_on_triangle(
        points[:, None, :], take(grid.tri_a, cand_c), take(grid.tri_b, cand_c),
        take(grid.tri_c, cand_c))
    d = torch.linalg.norm(cp - points[:, None, :], dim=-1)
    d = torch.where(valid, d, torch.full_like(d, float("inf")))
    return cand_c, cp, d


def mesh_contact_query(grid: MeshGrid, points: torch.Tensor):
    """Closest surface point and normal for query points (P, 3): (sdist
    (P,), normal (P, 3), closest (P, 3)).  ``sdist`` is negative behind
    the closest triangle's winding normal and +inf in an empty cell; ties
    go to the first candidate."""
    cand_c, cp, d = _candidates(grid, points)
    best = torch.argmin(d, dim=1)
    closest = torch.take_along_dim(cp, best[:, None, None], dim=1)[:, 0]
    dist = torch.take_along_dim(d, best[:, None], dim=1)[:, 0]
    tri_idx = torch.take_along_dim(cand_c, best[:, None], dim=1)[:, 0]
    tri_n = take(grid.tri_n, tri_idx)
    sign = torch.sign(torch.sum((points - closest) * tri_n, dim=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return dist * sign, tri_n, closest


def mesh_closest_triangle(grid: MeshGrid, points: torch.Tensor) -> torch.Tensor:
    """(P,) nearest candidate triangle per point (0 in an empty cell:
    pair it with a distance check)."""
    cand_c, _, d = _candidates(grid, points)
    best = torch.argmin(d, dim=1)
    return torch.take_along_dim(cand_c, best[:, None], dim=1)[:, 0]
