"""Refined SuGaR in the PyTorch port vs the JAX package, on the CPU.

Meshes are ``tests/test_sugar.py``'s subdivided octahedron (32 faces at
one subdivision, its vertices jittered) and a strip of six triangles.  Budgets:

- ``bind_to_mesh``, ``splat_mesh``, ``bake_texture``, the adjacency and
  ``postprocess_bound_mesh``: equal (texture and splatted vertices at
  1e-5 relative);
- ``realize``: centres, scales, opacities and colours at 1e-5 relative,
  quaternions equal up to sign, and its gradient against ``jax.grad``
  within 5e-4 of the largest, against the JAX package's ``realize`` with
  unit tangent frames (``jax_realize_unit``: the reference's divides by
  a matrix norm, a defect the port fixes and
  ``test_realize_frames_are_unit_where_the_reference_scales_them_by_a_matrix_norm``
  pins);
- both mesh losses and their gradients: 1e-5 and 5e-4;
- the export: the decoded PNG's pixels equal, the OBJ and MTL text
  equal;
- ``refine_train`` over 3 steps on JAX's camera draws (its loop with
  unit-frame splats): every trained field within 5e-4 of its largest;
- the port's Adam against optax's chain on the same gradients over 3
  steps: every field at 1e-6 relative.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.sugar import refine as JR
from autovfx_tpu.sugar import refine_train as JRT
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.edit.mesh_io import Mesh
from autovfx_tpu_torch.sugar import refine as R
from autovfx_tpu_torch.sugar import refine_train as RT
from autovfx_tpu_torch.utils import png
from test_sugar import _octa_mesh
from torch_sugar_common import (
    GRAD_TOL,
    JCFG,
    PCFG,
    close,
    jax_render,
    port_camera,
    ring,
)

ADAM_RTOL = 1e-6
BOUND_FIELDS = ("vertices", "log_scales2d", "rot_complex", "vertex_colors",
                "opacity_logit")


def jax_realize_unit(bg):
    """The JAX package's ``realize`` with unit tangent frames: there
    (``sugar/refine.py:342-343``) ``jnp.linalg.norm(x, -1, keepdims=True)``
    passes -1 as ``ord``, so the normal and the first tangent of every
    face are divided by one matrix norm of all of them, the frame is not
    orthonormal and the quaternions come from a non-rotation.  The port
    normalizes each row."""
    from autovfx_tpu.core.gaussians import Gaussians as JGaussians
    from autovfx_tpu.core.quaternion import rotmat_to_quat
    from autovfx_tpu.core.sh import rgb_to_sh

    unit = lambda x: x / jnp.maximum(
        jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    tri = bg.vertices[bg.faces]
    n_b = bg.bary.shape[0]
    centers = jnp.einsum("bk,fkj->fbj", bg.bary, tri).reshape(-1, 3)
    e1 = tri[:, 1] - tri[:, 0]
    nrm = unit(jnp.cross(e1, tri[:, 2] - tri[:, 0]))
    t1 = unit(e1)
    t2 = jnp.cross(nrm, t1)
    t1, t2, nrm = (jnp.repeat(x, n_b, axis=0) for x in (t1, t2, nrm))
    c = bg.rot_complex / jnp.maximum(
        jnp.linalg.norm(bg.rot_complex, axis=-1, keepdims=True), 1e-9)
    a1 = c[:, 0:1] * t1 + c[:, 1:2] * t2
    a2 = -c[:, 1:2] * t1 + c[:, 0:1] * t2
    quats = rotmat_to_quat(jnp.stack([a1, a2, nrm], axis=-1))
    s2d = jnp.exp(bg.log_scales2d)
    thickness = bg.thickness_ratio * jnp.min(s2d, axis=-1, keepdims=True)
    colors = jnp.einsum("bk,fkj->fbj", bg.bary,
                        bg.vertex_colors[bg.faces]).reshape(-1, 3)
    n = centers.shape[0]
    return JGaussians(
        xyz=centers, sh_dc=rgb_to_sh(jnp.clip(colors, 0.0, 1.0)),
        sh_rest=jnp.zeros((n, 15, 3), jnp.float32),
        log_scales=jnp.log(jnp.concatenate([s2d, thickness], axis=-1)),
        quats=quats, opacity_logit=bg.opacity_logit,
        active=jnp.ones((n,), bool))


def port_mesh(m) -> Mesh:
    return Mesh(vertices=m.vertices, faces=m.faces,
                vertex_colors=m.vertex_colors)


def port_bound(bg) -> R.BoundGaussians:
    return convert.bound_gaussians(
        {f: np.asarray(getattr(bg, f)) for f in BOUND_FIELDS + (
            "faces", "bary")} | {"thickness_ratio": bg.thickness_ratio},
        device="cpu")


def strip_mesh():
    v = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0], [0, 1, 0],
                  [1, 1, 0], [2, 1, 0], [3, 1, 0]], np.float32)
    f = np.array([[0, 1, 4], [1, 5, 4], [1, 2, 5], [2, 6, 5], [2, 3, 6],
                  [3, 7, 6]], np.int64)
    return v, f


@pytest.fixture(scope="module")
def octa():
    m = _octa_mesh(subdiv=1)
    rng = np.random.default_rng(0)
    m = m._replace(vertices=(m.vertices + 0.05 * rng.standard_normal(
        m.vertices.shape)).astype(np.float32))
    return m


@pytest.mark.parametrize("n", [1, 3, 4, 6])
def test_bind_and_realize(octa, n):
    bj = JR.bind_to_mesh(octa, n_per_triangle=n)
    b = R.bind_to_mesh(port_mesh(octa), n_per_triangle=n, device="cpu")
    for f in BOUND_FIELDS + ("faces", "bary"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(bj, f)))
    params = {f: getattr(bj, f) for f in BOUND_FIELDS}
    gj = jax.jit(lambda p: jax_realize_unit(bj.replace(**p)))(params)
    gr = jax.jit(lambda p: JR.realize(bj.replace(**p)))(params)
    g = R.realize(b)
    for f in ("xyz", "sh_dc", "sh_rest", "log_scales", "opacity_logit"):
        close(getattr(g, f), getattr(gj, f), what=f)
        close(getattr(g, f), getattr(gr, f), what=f)
    q, qj = g.quats.numpy(), np.asarray(gj.quats)
    sign = np.where(np.sum(q * qj, axis=1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(q * sign, qj, atol=1e-5)


def test_realize_frames_are_unit_where_the_reference_scales_them_by_a_matrix_norm(
        octa):
    """The port's splats lie in their triangles' planes with the normal
    as their thin axis; the reference's quaternions come from frames
    scaled by one matrix norm and are not those rotations."""
    bj = JR.bind_to_mesh(octa, n_per_triangle=1)
    g = R.realize(port_bound(bj))
    tri = octa.vertices[octa.faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    port_n = g.normals().numpy()  # the min-scale (thickness) axis
    assert np.abs(np.abs(np.sum(port_n * nrm, axis=1)) - 1).max() < 1e-5
    ref_n = np.asarray(JR.realize(bj).normals())
    assert np.abs(np.abs(np.sum(ref_n * nrm, axis=1)) - 1).max() > 0.1


def test_realize_gradient(octa):
    bj = JR.bind_to_mesh(octa, n_per_triangle=3)
    rng = np.random.default_rng(1)
    rot = rng.standard_normal((bj.log_scales2d.shape[0], 2)).astype(np.float32)
    bj = bj.replace(rot_complex=jnp.asarray(rot))
    w = {f: rng.standard_normal(s).astype(np.float32) for f, s in (
        ("xyz", (bj.num_gaussians, 3)), ("quats", (bj.num_gaussians, 4)),
        ("log_scales", (bj.num_gaussians, 3)))}
    fields = ("vertices", "log_scales2d", "rot_complex", "vertex_colors")

    def loss_j(p):
        g = jax_realize_unit(bj.replace(**p))
        return (jnp.sum(g.xyz * w["xyz"]) + jnp.sum(g.quats * w["quats"])
                + jnp.sum(g.log_scales * w["log_scales"]) + jnp.sum(g.sh_dc))

    want = jax.jit(jax.grad(loss_j))({f: getattr(bj, f) for f in fields})
    b = port_bound(bj)
    p = {f: getattr(b, f).clone().requires_grad_(True) for f in fields}
    g = R.realize(b.replace(**p))
    t = {k: torch.as_tensor(v) for k, v in w.items()}
    loss = (torch.sum(g.xyz * t["xyz"]) + torch.sum(g.quats * t["quats"])
            + torch.sum(g.log_scales * t["log_scales"]) + torch.sum(g.sh_dc))
    for f, gr in zip(fields, torch.autograd.grad(loss, list(p.values()))):
        assert bool(torch.isfinite(gr).all()), f
        close(gr, want[f], rtol=GRAD_TOL, what=f"d/d{f}")


@pytest.mark.parametrize("mode", ["perspective", "depth"])
def test_splat_mesh(octa, mode):
    cam = JC.look_at_camera([3.0, 0, 0.5], [0, 0, 0], [0, 0, 1], fx=50.0,
                            fy=50.0, width=64, height=48)
    bj = JR.bind_to_mesh(octa)
    want = JR.splat_mesh(bj, cam, mode=mode)
    got = R.splat_mesh(port_bound(bj), port_camera(cam), mode=mode)
    close(got.vertices, want.vertices, what=mode)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertex_colors, want.vertex_colors,
                               atol=1e-6)


def test_bake_texture_and_export(octa, tmp_path):
    bj = JR.bind_to_mesh(octa)
    b = port_bound(bj)
    tex_j, uv_j = JR.bake_texture(bj, texture_size=128, square_size=8)
    tex, uv = R.bake_texture(b, texture_size=128, square_size=8)
    np.testing.assert_array_equal(uv, uv_j)
    close(tex, tex_j, what="texture")
    with pytest.raises(ValueError):  # where the reference asserts
        R.bake_texture(b, texture_size=16, square_size=8)
    assert R.texture_size_for(len(octa.faces), least=16) == 32
    JR.export_refined_mesh(bj, str(tmp_path / "jax.obj"), 128)
    R.export_refined_mesh(b, str(tmp_path / "port.obj"), 128)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "port.png")),
                                  png.read_png(str(tmp_path / "jax.png")))
    for ext in (".obj", ".mtl"):
        got = (tmp_path / f"port{ext}").read_text().replace("port", "X")
        assert got == (tmp_path / f"jax{ext}").read_text().replace("jax", "X")


def test_postprocess_bound_mesh(octa):
    v, f = strip_mesh()
    for mesh, logit, iters in ((Mesh(v, f), -4.0, 1), (Mesh(v, f), 0.0, 1),
                               (octa, -4.0, 2)):
        bj = JR.bind_to_mesh(mesh, n_per_triangle=3)
        rng = np.random.default_rng(2)
        bj = bj.replace(opacity_logit=jnp.asarray(
            logit + 3 * rng.standard_normal(bj.opacity_logit.shape),
            jnp.float32))
        want = JR.postprocess_bound_mesh(bj, iterations=iters)
        got = R.postprocess_bound_mesh(port_bound(bj), iterations=iters)
        for fld in ("faces", "log_scales2d", "rot_complex", "opacity_logit"):
            np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                          np.asarray(getattr(want, fld)))


def test_adjacency_and_mesh_losses(octa):
    adj_j = JRT.mesh_adjacency(octa.faces, len(octa.vertices))
    adj = RT.mesh_adjacency(octa.faces, len(octa.vertices))
    for a, aj in zip(adj, adj_j):
        np.testing.assert_array_equal(a, aj)
    vj, fj = jnp.asarray(octa.vertices), jnp.asarray(octa.faces)
    pairs_j = jnp.asarray(adj_j.face_pairs)
    adj_dev = JRT.MeshAdjacency(*(jnp.asarray(x) for x in adj_j))
    v = torch.as_tensor(octa.vertices).requires_grad_(True)
    f = torch.as_tensor(octa.faces)
    pairs = torch.as_tensor(adj.face_pairs).long()
    src, dst = (torch.as_tensor(x).long() for x in (adj.edge_src,
                                                    adj.edge_dst))
    deg = torch.as_tensor(adj.degree)
    for name, lj, lp in (
            ("normal", lambda x: JRT.normal_consistency_loss(x, fj, pairs_j),
             lambda x: RT.normal_consistency_loss(x, f, pairs)),
            ("laplacian", lambda x: JRT.laplacian_loss(x, adj_dev),
             lambda x: RT.laplacian_loss(x, src, dst, deg))):
        val, grad = jax.value_and_grad(lj)(vj)
        got = lp(v)
        close(got, float(val), what=name)
        close(torch.autograd.grad(got, v)[0], grad, rtol=GRAD_TOL,
              what=f"{name} gradient")


def test_refine_train_against_optax(octa, monkeypatch):
    # the reference's loop and optax around unit-frame splats
    monkeypatch.setattr(JRT, "realize", jax_realize_unit)
    gt = JR.bind_to_mesh(octa, n_per_triangle=1)
    cams = ring(4, width=48, height=36, radius=2.5, fx=40.0)
    imgs = np.stack([np.asarray(jax_render(JR.realize(gt), c).color)
                     for c in cams])
    # uneven in-plane scales: with equal ones the in-plane rotation's
    # gradient is rounding noise, which Adam's normalized first step
    # turns into a full step of either sign
    start = gt.replace(
        vertex_colors=jnp.full_like(gt.vertex_colors, 0.5),
        log_scales2d=gt.log_scales2d + jnp.asarray(
            np.random.default_rng(3).normal(0, 0.3, gt.log_scales2d.shape),
            jnp.float32))
    kw = dict(iterations=3, normal_consistency=0.1, laplacian=0.05,
              feature_lr=0.05)
    want, _ = JRT.refine_train(start, JC.stack_cameras(cams), imgs,
                               JRT.RefineConfig(raster=JCFG, **kw))
    key, cam_idx = jax.random.PRNGKey(0), []
    for _ in range(3):
        key, k1 = jax.random.split(key)
        cam_idx.append(int(jax.random.randint(k1, (), 0, len(cams))))
    got, hist = RT.refine_train(
        port_bound(start), C.stack_cameras([port_camera(c) for c in cams]),
        torch.as_tensor(imgs), RT.RefineConfig(raster=PCFG, **kw),
        log_every=1, cam_indices=cam_idx)
    for f in BOUND_FIELDS:
        close(getattr(got, f), getattr(want, f), rtol=GRAD_TOL, what=f)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)


def test_adam_matches_optax(octa):
    """Three updates from the same gradients: the port's Adam against
    ``refine_train._make_optimizer``'s optax chain, with the position
    schedule past its first step."""
    cfg = RT.RefineConfig(position_lr_max_steps=2)
    jcfg = JRT.RefineConfig(position_lr_max_steps=2)
    bj = JR.bind_to_mesh(octa, n_per_triangle=1)
    scale = RT.spatial_lr_scale(torch.as_tensor(octa.vertices))
    tx = JRT._make_optimizer(jcfg, scale)
    params_j = {k: getattr(bj, k) for k in BOUND_FIELDS}
    opt = tx.init(params_j)
    params = {k: torch.as_tensor(np.array(v)) for k, v in params_j.items()}
    adam = RT.AdamState.zero(params)
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 * 10.0 ** rng.uniform(-4, 0) for k, v in params_j.items()}
        updates, opt = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                 opt, params_j)
        params_j = {k: params_j[k] + updates[k] for k in params_j}
        RT.adam_update(params, {k: torch.as_tensor(v) for k, v in
                                grads.items()}, adam, cfg, scale)
    for k in BOUND_FIELDS:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(params_j[k]),
                                   rtol=ADAM_RTOL, err_msg=k)
