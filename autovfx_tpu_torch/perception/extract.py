"""Object extraction from the scene: masks -> triangle votes -> meshes and
splats.

Counterpart of ``autovfx_tpu/perception/extract.py``:

- ``extract_object_from_scene``: per-frame DEVA masks -> rays through
  mask pixels -> first-hit triangles on the scene mesh -> per-triangle
  view votes -> a sweep of vote-ratio thresholds, picked by the least
  XOR between the selected splats' rendered alpha and the masks ->
  object_mesh.obj / removal_mesh.obj / object_gaussians.ply /
  removal_gaussians.ply.
- ``get_largest_object``: the instance with the most mask pixels.
- ``inpaint_object``: object removal's inputs, a planar convex-hull patch
  at the object's z-min merged into the removal mesh, and for each view
  the removal splats' render, its hole (alpha < 0.3) and its LaMa
  inpaint, written as PNGs with the views' poses.

The votes, the splat-to-triangle map and the sweep's renders (kernels
1-3 through the scene's ``rasterize`` on the card) stay on the scene's
device; only the exported meshes, PLYs and PNGs go through the host.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import ply_io
from autovfx_tpu_torch.edit import mesh_io
from autovfx_tpu_torch.ops.raymesh import ray_mesh_first_hit
from autovfx_tpu_torch.perception.wrappers import (
    inpaint_img_with_lama,
    load_instance_masks,
)
from autovfx_tpu_torch.utils import png

VOTE_THRESHOLDS = np.linspace(0.05, 0.95, 22)  # the sweep
RAY_STRIDE = 4  # subsample mask pixels for ray casting
CLOSEST_CHUNK = 1 << 17  # splats per nearest-triangle query


def get_largest_object(scene_representation, object_name, obj_ids) -> int:
    """The instance with the most mask pixels over all frames (the first
    of equal ones)."""
    tracking_dir = os.path.join(
        scene_representation.tracking_results_dir,
        "_".join(object_name.split(" ")),
    )
    best, best_id = -1, obj_ids[0]
    for oid in obj_ids:
        tot = int(load_instance_masks(tracking_dir, oid).sum())
        if tot > best:
            best, best_id = tot, oid
    return best_id


def _mask_rays(cam: C.Camera, mask: torch.Tensor, stride: int):
    """Unit rays from the camera center through every ``stride``-th
    pixel (both axes) where ``mask`` (H, W, on the camera's device) is
    set: (origins (R, 3), directions (R, 3))."""
    ys, xs = torch.nonzero(mask[::stride, ::stride], as_tuple=True)
    d = cam.ray_directions()[ys * stride, xs * stride]
    d = d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True), min=1e-12)
    o = cam.center[None, :].expand(d.shape[0], 3)
    return o, d


PIL_BITS = 22  # the fixed-point bits of the image library's 8-bit resampling


def _cubic(x: np.ndarray) -> np.ndarray:
    """The resampling library's bicubic kernel (a = -0.5)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) float64 fixed-point weights of one bicubic pass from
    ``n_in`` to ``n_out`` samples, as PIL's ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` make them (the support widened by the
    downscale, the weights summed in order and rounded half away from
    zero to ``PIL_BITS`` bits)."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xlen = np.minimum((center + support + 0.5).astype(np.int64), n_in) - xmin
    j = np.arange(ksize)
    used = j[None] < xlen[:, None]
    w = np.where(used, _cubic((j[None] + xmin[:, None] - center[:, None]
                               + 0.5) * (1.0 / fscale)), 0.0)
    total = np.zeros(n_out)
    for k in range(ksize):  # in order, as the library sums them
        total = total + w[:, k]
    w = np.where(total[:, None] != 0.0,
                 w / np.where(total != 0.0, total, 1.0)[:, None], w)
    w = w * float(1 << PIL_BITS)
    w = np.where(w < 0, np.trunc(-0.5 + w), np.trunc(0.5 + w))
    m = np.zeros((n_in, n_out))
    rows = np.minimum(xmin[:, None] + j[None], n_in - 1)
    cols = np.broadcast_to(np.arange(n_out)[:, None], rows.shape)
    np.add.at(m, (rows[used], cols[used]), w[used])
    return torch.tensor(m, dtype=torch.float64, device=device)


def _resample_pass(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """One pass along the last axis, rounded and clipped to 8 bits as the
    library does.  Every product and sum is an integer below 2^40, so
    the float64 product is exact in any order."""
    acc = img @ m + float(1 << (PIL_BITS - 1))
    return torch.clamp(torch.floor(acc / float(1 << PIL_BITS)), 0.0, 255.0)


def _resize_mask(mask: np.ndarray, height: int, width: int,
                 device) -> torch.Tensor:
    """A boolean mask on ``device`` at (height, width): as an 8-bit image
    (0/255) resized by PIL's default bicubic filter, width first, then
    height, and thresholded above 127, as the reference does."""
    img = torch.tensor(np.asarray(mask, bool), device=device)
    if tuple(mask.shape) == (height, width):
        return img
    img = img.double() * 255.0
    if mask.shape[1] != width:
        img = _resample_pass(img, _resample_matrix(mask.shape[1], width,
                                                   device))
    if mask.shape[0] != height:
        img = _resample_pass(img.T, _resample_matrix(mask.shape[0], height,
                                                     device)).T
    return img > 127


def _triangles(mesh: mesh_io.Mesh, device):
    return tuple(torch.tensor(np.asarray(mesh.vertices[mesh.faces[:, k]],
                                         np.float32), device=device)
                 for k in range(3))


def _hit_counts(cam, mask, stride, tris, n_faces) -> torch.Tensor:
    """(T,) int64: how many rays through ``mask``'s pixels hit each
    triangle first."""
    o, d = _mask_rays(cam, mask, stride)
    if o.shape[0] == 0:
        return torch.zeros(n_faces, dtype=torch.int64, device=mask.device)
    _, idx, hit = ray_mesh_first_hit(o, d, *tris)
    return torch.bincount(idx[hit], minlength=n_faces)


def extract_object_from_scene(
    scene_representation, object_name: str, obj_id: int
) -> str:
    """Split the scene mesh and its splats into the object and the rest.

    Returns the object mesh's path; writes the four artefacts beside it
    (``<cache>/extract/<name>/<id>/``)."""
    sr = scene_representation
    dev = sr.device
    base = os.path.join(
        sr.cache_dir, "extract", "_".join(object_name.split(" ")), str(obj_id)
    )
    obj_mesh_path = os.path.join(base, "object_mesh", "object_mesh.obj")
    if os.path.exists(obj_mesh_path):
        return obj_mesh_path
    os.makedirs(os.path.dirname(obj_mesh_path), exist_ok=True)
    os.makedirs(os.path.join(base, "removal_mesh"), exist_ok=True)

    scene_mesh = mesh_io.load_mesh(sr.scene_mesh_path_for_blender)
    tris = _triangles(scene_mesh, dev)
    n_faces = len(scene_mesh.faces)

    tracking_dir = os.path.join(
        sr.tracking_results_dir, "_".join(object_name.split(" "))
    )
    masks_np = load_instance_masks(tracking_dir, obj_id)  # (F, H, W)
    cam0 = C.index_camera(sr.cameras, 0)
    masks = torch.stack([_resize_mask(m, cam0.height, cam0.width, dev)
                         for m in masks_np])

    # rays through mask pixels vote for their first-hit triangle; rays
    # through the other pixels (at twice the stride) mark triangles as
    # seen outside the mask
    votes = torch.zeros(n_faces, dtype=torch.int64, device=dev)
    seen = torch.zeros(n_faces, dtype=torch.int64, device=dev)
    for fi in range(min(len(masks), sr.total_frames)):
        cam = C.index_camera(sr.cameras, fi)
        votes += _hit_counts(cam, masks[fi], RAY_STRIDE, tris, n_faces)
        seen += _hit_counts(cam, ~masks[fi], RAY_STRIDE * 2, tris, n_faces)
    ratio = votes.double() / torch.clamp(votes + seen, min=1)

    # the threshold sweep: the selection whose rendered alpha best
    # matches the masks, summed over several tracked views (one bad
    # anchor mask cannot decide it)
    anchor = sr.hparams.anchor_frame_idx
    n_sweep = int(getattr(sr.hparams, "n_sweep_frames", 8))
    cand = np.unique(np.concatenate([
        [min(anchor, len(masks) - 1)],
        np.linspace(0, len(masks) - 1, n_sweep).astype(int),
    ]))
    visible = masks.flatten(1).any(dim=1).cpu().numpy()
    sweep_frames = [int(f) for f in cand if visible[f]] or [int(cand[0])]
    g = sr.gaussians
    gaussian_tri = _closest_triangle(g.xyz, scene_mesh)

    best = (1e18, None)
    for thr in VOTE_THRESHOLDS:
        tri_sel = ratio >= thr
        if not bool(tri_sel.any()):
            continue
        g_sel = tri_sel[gaussian_tri] & g.active
        xor_sum = 0.0
        for f in sweep_frames:
            camf = C.index_camera(sr.cameras, f)
            alpha = sr.rasterize(dataclasses.replace(g, active=g_sel),
                                 camf).alpha > 0.5
            xor_sum += int((alpha ^ masks[f]).sum()) / alpha.numel()
        xor = xor_sum / len(sweep_frames)
        if xor < best[0]:
            best = (xor, thr)
    thr = best[1] if best[1] is not None else 0.5
    tri_sel = ratio >= thr
    g_sel = tri_sel[gaussian_tri] & g.active

    # exports (object + removal)
    tri_np = tri_sel.cpu().numpy()
    _export_submesh(scene_mesh, tri_np,
                    os.path.join(base, "object_mesh", "object_mesh.obj"))
    _export_submesh(scene_mesh, ~tri_np,
                    os.path.join(base, "removal_mesh", "removal_mesh.obj"))
    ply_io.save_ply(os.path.join(base, "object_gaussians.ply"),
                    dataclasses.replace(g, active=g_sel))
    ply_io.save_ply(os.path.join(base, "removal_gaussians.ply"),
                    dataclasses.replace(g, active=~g_sel & g.active))
    return obj_mesh_path


def _closest_triangle(points: torch.Tensor, mesh: mesh_io.Mesh) -> torch.Tensor:
    """(N,) int64 nearest-triangle index per point, on the points'
    device: true point-to-triangle distances through the uniform mesh
    grid, in chunks of ``CLOSEST_CHUNK`` points (the lower index on a
    tie)."""
    from autovfx_tpu_torch.physics.shapes import (
        build_mesh_grid,
        mesh_closest_triangle,
    )

    grid = build_mesh_grid(mesh.vertices, mesh.faces, resolution=32,
                           device=points.device)
    return torch.cat([
        mesh_closest_triangle(grid, points[s:s + CLOSEST_CHUNK])
        for s in range(0, points.shape[0], CLOSEST_CHUNK)])


def _export_submesh(mesh: mesh_io.Mesh, tri_mask: np.ndarray, path: str):
    faces = mesh.faces[tri_mask]
    used = np.unique(faces)
    remap = np.full(len(mesh.vertices), -1, np.int64)
    remap[used] = np.arange(len(used))
    sub = mesh_io.Mesh(
        vertices=mesh.vertices[used],
        faces=remap[faces],
        vertex_colors=(
            mesh.vertex_colors[used]
            if mesh.vertex_colors is not None
            else None
        ),
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mesh_io.save_obj(path, sub)


def extract_object_from_single_view(scene_representation, object_name, mask):
    """The anchor view alone: the scene-mesh points that ``mask``'s rays
    (``RAY_STRIDE``) hit, (P, 3) float32 numpy."""
    sr = scene_representation
    cam = C.index_camera(sr.cameras, sr.hparams.anchor_frame_idx)
    scene_mesh = mesh_io.load_mesh(sr.scene_mesh_path_for_blender)
    o, d = _mask_rays(cam, torch.as_tensor(np.asarray(mask, bool),
                                           device=sr.device), RAY_STRIDE)
    t, _, hit = ray_mesh_first_hit(o, d, *_triangles(scene_mesh, sr.device))
    pts = o[hit] + d[hit] * t[hit, None]
    return pts.cpu().numpy()


HOLE_ALPHA = 0.3  # a removal render's pixels below this alpha are the hole
MAX_INPAINT_VIEWS = 24


def inpaint_object(scene_representation, object_name: str, obj_id) -> str:
    """Close the removal hole and make the inpainted training views under
    ``<cache>/extract/<name>/<id>/``; returns that directory.

    The patch is the convex hull of the object mesh's footprint (x, y)
    at its lowest z, fanned from the hull's mean, appended to the
    removal mesh as ``inpaint_removal_mesh/inpaint_removal_mesh.obj``.
    For each of the first min(frames, 24) views, the removal splats are
    rendered through the scene's ``rasterize`` (kernels 1-3 on the card),
    the pixels with alpha < 0.3 are the hole, and LaMa fills it on the
    scene's device: ``render_inpaint_lama/<i>.png``,
    ``render_inpaint_mask/<i>.png`` and ``inpaint_camera_poses.json``
    (the trajectory format, the views' OpenCV c2w)."""
    from scipy.spatial import ConvexHull

    sr = scene_representation
    base = os.path.join(sr.cache_dir, "extract",
                        "_".join(object_name.split(" ")), str(obj_id))
    removal = mesh_io.load_mesh(
        os.path.join(base, "removal_mesh", "removal_mesh.obj"))
    obj_mesh = mesh_io.load_mesh(
        os.path.join(base, "object_mesh", "object_mesh.obj"))

    z_min = float(obj_mesh.vertices[:, 2].min())
    xy = obj_mesh.vertices[:, :2]
    ring = xy[ConvexHull(xy).vertices]
    center = ring.mean(axis=0)
    patch_v = np.concatenate(
        [np.array([[center[0], center[1], z_min]]),
         np.column_stack([ring, np.full(len(ring), z_min)])]).astype(np.float32)
    n = len(ring)
    patch_f = np.array([[0, 1 + i, 1 + (i + 1) % n] for i in range(n)],
                       np.int64)
    merged = mesh_io.Mesh(
        vertices=np.concatenate([removal.vertices, patch_v]),
        faces=np.concatenate([removal.faces, patch_f + len(removal.vertices)]),
        vertex_colors=None)
    out_dir = os.path.join(base, "inpaint_removal_mesh")
    os.makedirs(out_dir, exist_ok=True)
    mesh_io.save_obj(os.path.join(out_dir, "inpaint_removal_mesh.obj"), merged)

    lama_dir = os.path.join(base, "render_inpaint_lama")
    mask_dir = os.path.join(base, "render_inpaint_mask")
    os.makedirs(lama_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    g_removal = ply_io.load_gaussians(
        os.path.join(base, "removal_gaussians.ply"), device=sr.device)
    cam_poses = []
    for fi in range(min(sr.total_frames, MAX_INPAINT_VIEWS)):
        cam = C.index_camera(sr.cameras, fi)
        out = sr.rasterize(g_removal, cam)
        rgb = torch.clamp(out.color, 0, 1).cpu().numpy()
        hole = (out.alpha < HOLE_ALPHA).cpu().numpy()
        name = f"{fi:05d}.png"
        inpainted = inpaint_img_with_lama(
            rgb, hole, cache_path=os.path.join(lama_dir, name),
            device=sr.device)
        png.write_png(os.path.join(lama_dir, name), np.asarray(inpainted,
                                                                np.uint8))
        png.write_png(os.path.join(mask_dir, name),
                      hole.astype(np.uint8) * 255)
        cam_poses.append(cam.c2w.cpu().numpy().tolist())

    cam0 = C.index_camera(sr.cameras, 0)
    with open(os.path.join(base, "inpaint_camera_poses.json"), "w") as f:
        json.dump({
            "fl_x": float(cam0.fx), "fl_y": float(cam0.fy),
            "cx": float(cam0.cx), "cy": float(cam0.cy),
            "w": int(sr.cameras.width), "h": int(sr.cameras.height),
            "frames": [{"filename": f"{i:05d}.png", "transform_matrix": m}
                       for i, m in enumerate(cam_poses)],
        }, f)
    return base
