"""Refined SuGaR: Gaussians bound to a mesh, and texture baking.

Counterpart of ``autovfx_tpu/sugar/refine.py`` (itself
``sugar_scene/sugar_model.py``'s mesh-bound mode :170-210 and :322-337,
texture baking :2398-2616 and ``convert_refined_sugar_into_gaussians``
:2617-2638, and ``refined_mesh.py``'s export): n ∈ {1, 3, 4, 6}
Gaussians a triangle at fixed barycentric coordinates, learnable 2-D
scales, an in-plane rotation as a complex number, vertex colours and
opacities; the vertices move with refinement.

``splat_mesh`` is plain tensor code (the JAX package's
``utils/linalg.transform_points`` is a TPU matmul workaround), and the
texture is written with ``utils/png``: the machine with the card has no
image library.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.core.quaternion import rotmat_to_quat
from autovfx_tpu_torch.core.sh import rgb_to_sh
from autovfx_tpu_torch.edit.mesh_io import Mesh
from autovfx_tpu_torch.utils import png

# fixed barycentric coordinates per Gaussians-per-triangle count
# (sugar_model.py:170-210)
_BARY = {
    1: np.array([[1 / 3, 1 / 3, 1 / 3]], np.float32),
    3: np.array([[1 / 2, 1 / 4, 1 / 4], [1 / 4, 1 / 2, 1 / 4],
                 [1 / 4, 1 / 4, 1 / 2]], np.float32),
    4: np.array([[1 / 3, 1 / 3, 1 / 3], [2 / 3, 1 / 6, 1 / 6],
                 [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3]], np.float32),
    6: np.array([[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6],
                 [1 / 6, 1 / 6, 2 / 3], [1 / 6, 5 / 12, 5 / 12],
                 [5 / 12, 1 / 6, 5 / 12], [5 / 12, 5 / 12, 1 / 6]],
                np.float32),
}
# the trained fields
PARAM_KEYS = ("vertices", "log_scales2d", "rot_complex", "vertex_colors",
              "opacity_logit")


@dataclasses.dataclass(frozen=True)
class BoundGaussians:
    """Surface-bound splats; their positions follow the mesh."""

    vertices: torch.Tensor  # (V, 3), learnable: refinement moves the mesh
    faces: torch.Tensor  # (F, 3) int64
    bary: torch.Tensor  # (n, 3)
    log_scales2d: torch.Tensor  # (F*n, 2) tangent-plane scales
    rot_complex: torch.Tensor  # (F*n, 2) in-plane rotation (cos, sin)
    vertex_colors: torch.Tensor  # (V, 3)
    opacity_logit: torch.Tensor  # (F*n,)
    thickness_ratio: float = 0.05

    @property
    def num_gaussians(self) -> int:
        return self.faces.shape[0] * self.bary.shape[0]

    def replace(self, **fields) -> "BoundGaussians":
        return dataclasses.replace(self, **fields)


def bind_to_mesh(mesh: Mesh, n_per_triangle: int = 1,
                 initial_opacity: float = 0.9,
                 device=devices.DEFAULT) -> BoundGaussians:
    """``n_per_triangle`` Gaussians on each face of ``mesh``: 2-D scale
    sqrt(area / n), no in-plane rotation, the mesh's vertex colours (0.5
    grey without), opacity ``initial_opacity``."""
    device = devices.resolve(device)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=device
                                                    ).to(dt)
    n = mesh.faces.shape[0] * n_per_triangle
    e1 = mesh.vertices[mesh.faces[:, 1]] - mesh.vertices[mesh.faces[:, 0]]
    e2 = mesh.vertices[mesh.faces[:, 2]] - mesh.vertices[mesh.faces[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    s0 = np.sqrt(np.maximum(area / max(n_per_triangle, 1), 1e-12))
    log_s = np.log(np.repeat(s0, n_per_triangle))[:, None].repeat(2, 1)
    vc = (mesh.vertex_colors if mesh.vertex_colors is not None
          else np.full((len(mesh.vertices), 3), 0.5, np.float32))
    op = float(np.log(initial_opacity / (1 - initial_opacity)))
    rot = torch.zeros((n, 2), dtype=torch.float32, device=device)
    rot[:, 0] = 1.0
    return BoundGaussians(
        vertices=t(mesh.vertices),
        faces=t(mesh.faces, torch.int64),
        bary=t(_BARY[n_per_triangle]),
        log_scales2d=t(log_s),
        rot_complex=rot,
        vertex_colors=t(vc),
        opacity_logit=torch.full((n,), op, dtype=torch.float32, device=device),
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def realize(bg: BoundGaussians) -> Gaussians:
    """The bound splats as a plain ``Gaussians`` store (differentiable in
    the bound parameters): centres at the barycentric points, the axes
    the triangle's tangent frame turned in plane by ``rot_complex`` and
    its normal, the third scale ``thickness_ratio`` of the smaller."""
    tri = bg.vertices[bg.faces]  # (F, 3, 3)
    n_b = bg.bary.shape[0]
    centers = torch.einsum("bk,fkj->fbj", bg.bary, tri).reshape(-1, 3)

    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    nrm = _cross(e1, e2)
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                            min=1e-12)
    t1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True),
                          min=1e-12)
    t2 = _cross(nrm, t1)
    t1, t2, nrm_r = (torch.repeat_interleave(x, n_b, dim=0)
                     for x in (t1, t2, nrm))

    c = bg.rot_complex / torch.clamp(
        torch.linalg.norm(bg.rot_complex, dim=-1, keepdim=True), min=1e-9)
    a1 = c[:, 0:1] * t1 + c[:, 1:2] * t2
    a2 = -c[:, 1:2] * t1 + c[:, 0:1] * t2
    quats = rotmat_to_quat(torch.stack([a1, a2, nrm_r], dim=-1))  # columns

    s2d = torch.exp(bg.log_scales2d)
    thickness = bg.thickness_ratio * torch.amin(s2d, dim=-1, keepdim=True)
    log_scales = torch.log(torch.cat([s2d, thickness], dim=-1))
    colors = torch.einsum("bk,fkj->fbj", bg.bary,
                          bg.vertex_colors[bg.faces]).reshape(-1, 3)
    n = centers.shape[0]
    dev = centers.device
    return Gaussians(
        xyz=centers,
        sh_dc=rgb_to_sh(torch.clamp(colors, 0.0, 1.0)),
        sh_rest=torch.zeros((n, 15, 3), dtype=torch.float32, device=dev),
        log_scales=log_scales,
        quats=quats,
        opacity_logit=bg.opacity_logit,
        active=torch.ones((n,), dtype=torch.bool, device=dev),
    )


def splat_mesh(bg: BoundGaussians, cam, mode: str = "perspective") -> Mesh:
    """Each face's vertices moved to its centroid's viewing depth
    (sugar_model.py:567-601), as a mesh of unshared triangles coloured
    at their first barycentric point: ``depth`` sets each vertex's view z
    to the centroid's, ``perspective`` rescales each along its ray so
    that its projection on the centroid's direction is the centroid's."""
    with torch.no_grad():
        tri = bg.vertices[bg.faces]  # (F, 3, 3)
        centers = torch.mean(tri, dim=1, keepdim=True)  # (F, 1, 3)
        to_cam = lambda p: p @ cam.R.T + cam.t
        tri_cam, ctr_cam = to_cam(tri), to_cam(centers)
        if mode == "depth":
            new_cam = torch.cat([tri_cam[..., :2], ctr_cam[..., 2:].expand(
                tri_cam[..., 2:].shape)], dim=-1)
        else:
            proj_dir = ctr_cam / torch.clamp(
                torch.linalg.norm(ctr_cam, dim=-1, keepdim=True), min=1e-12)
            verts_proj = torch.sum(tri_cam * proj_dir, dim=-1, keepdim=True)
            ctr_proj = torch.sum(ctr_cam * proj_dir, dim=-1, keepdim=True)
            new_cam = (ctr_proj / torch.where(
                torch.abs(verts_proj) > 1e-9, verts_proj,
                torch.full_like(verts_proj, 1e-9))) * tri_cam
        # back to the world: p_w = Rᵀ (p_c − t)
        world = (new_cam.reshape(-1, 3) - cam.t[None]) @ cam.R
        vc = torch.einsum("bk,fkj->fbj", bg.bary[:1],
                          bg.vertex_colors[bg.faces]).reshape(-1, 3)
    n_faces = bg.faces.shape[0]
    vc = np.repeat(vc.cpu().numpy(), 3, axis=0)
    return Mesh(vertices=world.cpu().numpy().astype(np.float32),
                faces=np.arange(n_faces * 3, dtype=np.int64).reshape(-1, 3),
                vertex_colors=np.clip(vc, 0.0, 1.0).astype(np.float32))


def bake_texture(bg: BoundGaussians, texture_size: int = 1024,
                 square_size: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Per-triangle colour squares in a UV atlas
    (``extract_texture_image_and_uv_from_gaussians``): two faces share a
    ``square_size`` square, the first above its anti-diagonal, the second
    below, each a barycentric gradient of its vertex colours.  Returns
    (texture (S, S, 3) float, per-corner uv (F*3, 2))."""
    f = bg.faces.cpu().numpy()
    vc = bg.vertex_colors.detach().cpu().numpy()
    n_faces = len(f)
    per_row = texture_size // square_size
    if n_faces > 2 * per_row * per_row:
        raise ValueError(f"a {texture_size}² texture of {square_size}² "
                         f"squares holds {2 * per_row * per_row} faces, not "
                         f"{n_faces}")

    sq = np.arange(n_faces) // 2
    upper = np.arange(n_faces) % 2 == 0
    row = sq // per_row
    col = sq % per_row
    x0 = col * square_size
    y0 = row * square_size

    # the texel centres' barycentric weights, shared by every square: the
    # upper-left triangle's vertices at square corners (0,0), (1,0),
    # (0,1), the lower-right's at (1,1), (0,1), (1,0); clamped and
    # renormalized past the diagonal
    gr = (np.arange(square_size) + 0.5) / square_size
    uu, vv = np.meshgrid(gr, gr)
    w_up = np.stack([1.0 - uu - vv, uu, vv], axis=-1)
    w_lo = np.stack([uu + vv - 1.0, 1.0 - uu, 1.0 - vv], axis=-1)
    for w in (w_up, w_lo):
        np.clip(w, 0.0, None, out=w)
        w /= np.maximum(w.sum(-1, keepdims=True), 1e-9)

    tri_col = vc[f]  # (F, 3, 3)
    w_face = np.where(upper[:, None, None, None], w_up, w_lo)
    squares = np.einsum("fyxk,fkc->fyxc", w_face, tri_col)  # (F, s, s, 3)

    # each face writes its own half of its square (the upper face on and
    # above the anti-diagonal), so the faces' writes do not overlap
    tex = np.zeros((texture_size, texture_size, 3), np.float32)
    up_mask = uu + vv <= 1.0
    yy, xx = np.meshgrid(np.arange(square_size), np.arange(square_size),
                         indexing="ij")
    for is_up, m in ((True, up_mask), (False, ~up_mask)):
        sel = np.nonzero(upper == is_up)[0]
        ty, tx = yy[m], xx[m]
        tex[y0[sel, None] + ty[None], x0[sel, None] + tx[None]] = (
            squares[sel][:, m])

    eps = 1.0 / texture_size
    s = square_size / texture_size
    u0 = x0 / texture_size
    v0 = y0 / texture_size
    uv = np.where(
        upper[:, None, None],
        np.stack([np.stack([u0 + eps, v0 + eps], -1),
                  np.stack([u0 + s - eps, v0 + eps], -1),
                  np.stack([u0 + eps, v0 + s - eps], -1)], axis=1),
        np.stack([np.stack([u0 + s - eps, v0 + s - eps], -1),
                  np.stack([u0 + eps, v0 + s - eps], -1),
                  np.stack([u0 + s - eps, v0 + eps], -1)], axis=1),
    ).astype(np.float32)
    return tex, uv.reshape(-1, 2)


def texture_size_for(n_faces: int, square_size: int = 8,
                     least: int = 1024) -> int:
    """The smallest power-of-two texture side, at least ``least``, whose
    squares hold ``n_faces`` faces (two a square)."""
    size = least
    while n_faces > 2 * (size // square_size) ** 2:
        size *= 2
    return size


def postprocess_bound_mesh(bg: BoundGaussians, iterations: int = 1,
                           min_opacity: float = 0.1) -> BoundGaussians:
    """Strip the border faces before export (refined_mesh.py:129-191):
    ``iterations`` times remove every face with an unshared edge, then
    put back the removed faces whose Gaussians keep a mean opacity above
    ``min_opacity``; each kept face keeps its Gaussians' parameters."""
    faces = bg.faces.cpu().numpy()
    n_b = bg.bary.shape[0]
    keep = np.ones(len(faces), bool)
    for _ in range(max(iterations, 0)):
        fk = faces[keep]
        e = np.sort(np.stack([fk[:, [0, 1]], fk[:, [1, 2]], fk[:, [2, 0]]],
                             axis=1), axis=2).reshape(-1, 2)
        _, inv, counts = np.unique(e, axis=0, return_inverse=True,
                                   return_counts=True)
        # a face is inside when each of its edges has a second face
        keep[np.nonzero(keep)[0]] = (
            counts[inv.reshape(-1)].reshape(-1, 3) >= 2).all(axis=1)
    op = 1.0 / (1.0 + np.exp(-bg.opacity_logit.detach().cpu().numpy()))
    face_op = op.reshape(len(faces), n_b).mean(axis=1)
    keep |= (~keep) & (face_op > min_opacity)

    g_keep = torch.as_tensor(np.repeat(keep, n_b), device=bg.faces.device)
    return bg.replace(
        faces=bg.faces[torch.as_tensor(keep, device=bg.faces.device)],
        log_scales2d=bg.log_scales2d[g_keep],
        rot_complex=bg.rot_complex[g_keep],
        opacity_logit=bg.opacity_logit[g_keep],
    )


def export_refined_mesh(bg: BoundGaussians, path: str,
                        texture_size: int = 1024,
                        square_size: int = 8) -> None:
    """The refined surface as OBJ + MTL + PNG texture (``refined_mesh.py``'s
    textured-mesh export)."""
    tex, uv = bake_texture(bg, texture_size, square_size)
    base, _ = os.path.splitext(path)
    name = os.path.basename(base)
    v = bg.vertices.detach().cpu().numpy()
    f = bg.faces.cpu().numpy()
    png.write_png(base + ".png", (np.clip(tex, 0.0, 1.0) * 255).astype(np.uint8))
    with open(base + ".mtl", "w") as fh:
        fh.write(f"newmtl material_0\nKd 1.0 1.0 1.0\nmap_Kd {name}.png\n")
    lines = [f"mtllib {name}.mtl", "usemtl material_0"]
    lines += [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in v]
    # the OBJ's vt origin is bottom-left; the texture's rows run top-down
    lines += [f"vt {u:.6f} {1.0 - w:.6f}" for u, w in uv]
    for i, (a, b, c) in enumerate(f):
        t = 3 * i
        lines.append(f"f {a + 1}/{t + 1} {b + 1}/{t + 2} {c + 1}/{t + 3}")
    with open(base + ".obj", "w") as fh:
        fh.write("\n".join(lines) + "\n")
