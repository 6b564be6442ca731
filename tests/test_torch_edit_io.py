"""The port's copies of the JAX package's numpy modules, and its
checkpoint, trajectory and emitter loaders, against the originals.

- mesh IO: OBJ and PLY meshes written by one package and read by the
  other, a hand-built GLB, ``tests/test_fbx.py``'s FBX fixtures, and
  ``gltf_anim`` (``tests/test_gltf_anim.py``'s animated GLB);
- the edit IR's JSON, the event schedules, ``fracture`` pieces and
  ``decimate`` on int64 faces: equal;
- ``decimate._edges_of`` on int32 faces, where the reference's shift by
  32 (``sugar/decimate.py:44``) fails;
- the trajectory JSON across packages; ``load_gaussians`` on ``.ply``,
  ``.pt`` and ``.npz``; ``Gaussians.covariance`` / ``transformed`` and
  ``sh_rotation`` within 1e-5; ``load_emitter``.
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import test_fbx as TFBX  # noqa: E402
import test_gltf_anim as TGLB  # noqa: E402
from autovfx_tpu.core import cameras as JC  # noqa: E402
from autovfx_tpu.core import ply_io as JPLY  # noqa: E402
from autovfx_tpu.core import sh_rotation as JSHR  # noqa: E402
from autovfx_tpu.edit import edit_ir as JIR  # noqa: E402
from autovfx_tpu.edit import events as JEV  # noqa: E402
from autovfx_tpu.edit import gltf_anim as JGA  # noqa: E402
from autovfx_tpu.edit import mesh_io as JMIO  # noqa: E402
from autovfx_tpu.physics import fracture as JFR  # noqa: E402
from autovfx_tpu.render import emitter as JEM  # noqa: E402
from autovfx_tpu.sugar import decimate as JDEC  # noqa: E402
from autovfx_tpu.utils.synthetic import make_gaussians  # noqa: E402
from autovfx_tpu_torch import convert  # noqa: E402
from autovfx_tpu_torch.core import cameras as C  # noqa: E402
from autovfx_tpu_torch.core import ply_io as PLY  # noqa: E402
from autovfx_tpu_torch.core import quaternion as Q  # noqa: E402
from autovfx_tpu_torch.core import sh_rotation as SHR  # noqa: E402
from autovfx_tpu_torch.edit import edit_ir as IR  # noqa: E402
from autovfx_tpu_torch.edit import events as EV  # noqa: E402
from autovfx_tpu_torch.edit import gltf_anim as GA  # noqa: E402
from autovfx_tpu_torch.edit import mesh_io as MIO  # noqa: E402
from autovfx_tpu_torch.physics import fracture as FR  # noqa: E402
from autovfx_tpu_torch.render import emitter as EM  # noqa: E402
from autovfx_tpu_torch.sugar import decimate as DEC  # noqa: E402

TOL = 1e-5


def sphere_mesh(n_lat=12, n_lon=16, colors=True):
    """A closed UV sphere (two poles, quads split in two) with seeded
    vertex colors."""
    rng = np.random.default_rng(3)
    lat = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.outer(np.sin(lat), np.cos(lon)),
                     np.outer(np.sin(lat), np.sin(lon)),
                     np.outer(np.cos(lat), np.ones_like(lon))], -1)
    v = np.concatenate([[[0, 0, 1]], ring.reshape(-1, 3), [[0, 0, -1]]])
    idx = lambda i, j: 1 + i * n_lon + j % n_lon
    f = [[0, idx(0, j), idx(0, j + 1)] for j in range(n_lon)]
    for i in range(n_lat - 2):
        for j in range(n_lon):
            f += [[idx(i, j), idx(i + 1, j), idx(i + 1, j + 1)],
                  [idx(i, j), idx(i + 1, j + 1), idx(i, j + 1)]]
    last = len(v) - 1
    f += [[idx(n_lat - 2, j + 1), idx(n_lat - 2, j), last]
          for j in range(n_lon)]
    c = rng.random((len(v), 3)).astype(np.float32) if colors else None
    return v.astype(np.float32), np.array(f, np.int64), c


def same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    for k in ("vertex_colors", "uv"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ext", ["obj", "ply"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mesh_round_trip_across_packages(tmp_path, ext, writer):
    v, f, c = sphere_mesh()
    pkgs = {"port": MIO, "jax": JMIO}
    other = pkgs["jax" if writer == "port" else "port"]
    w = pkgs[writer]
    path = str(tmp_path / f"m.{ext}")
    save = w.save_obj if ext == "obj" else w.save_ply_mesh
    save(path, w.Mesh(vertices=v, faces=f, vertex_colors=c))
    same_mesh(MIO.load_mesh(path), JMIO.load_mesh(path))
    got = other.load_mesh(path)
    np.testing.assert_allclose(got.vertices, v, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.faces, f)
    m = MIO.load_mesh(path)
    for fn in ("bottom_center", "center", "extents", "face_normals"):
        np.testing.assert_array_equal(getattr(m, fn)(),
                                      getattr(JMIO.load_mesh(path), fn)())
    same_mesh(m.normalized_to_unit_box(),
              JMIO.load_mesh(path).normalized_to_unit_box())


def test_glb_loads_alike(tmp_path):
    p = str(tmp_path / "anim.glb")
    TGLB._build_glb(p)
    same_mesh(MIO.load_glb(p), JMIO.load_glb(p))


@pytest.mark.parametrize("kw", [
    dict(up_axis=2), dict(up_axis=1), dict(quad=False, with_uv=True),
    dict(translation=(1.0, 2.0, 3.0), rotation=(0.0, 0.0, 90.0),
         scaling=(2.0, 2.0, 2.0))], ids=["zup", "yup", "uv", "trs"])
@pytest.mark.parametrize("compress", [False, True])
def test_fbx_fixtures_load_alike(tmp_path, kw, compress):
    p = str(tmp_path / "cube.fbx")
    TFBX.write_fbx(p, TFBX._cube_nodes(**kw), version=7500,
                   compress=compress)
    same_mesh(MIO.load_mesh(p), JMIO.load_mesh(p))


@pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 1.25])
def test_gltf_animation_alike(tmp_path, t):
    p = str(tmp_path / "anim.glb")
    TGLB._build_glb(p, skinned=True)
    got, want = GA.load_animated_glb(p), JGA.load_animated_glb(p)
    assert got.duration == want.duration
    np.testing.assert_array_equal(got.vertices_at(t), want.vertices_at(t))
    same_mesh(got.rest_mesh(), want.rest_mesh())
    s = {"tri": np.array([0, 0]), "bary": np.array([[0.2, 0.3, 0.5],
                                                    [1.0, 0.0, 0.0]])}
    a = GA.surfels_on_deformed(s, got.vertices_at(t), got.faces)
    b = JGA.surfels_on_deformed(s, want.vertices_at(t), want.faces)
    for k in ("points", "normals"):
        np.testing.assert_array_equal(a[k], b[k])


def test_edit_ir_json_across_packages(tmp_path):
    obj = IR.default_object_info()
    obj["pos"] = np.array([1.0, 2.0, 3.0], np.float32)
    assert IR.default_object_info().keys() == JIR.default_object_info().keys()
    assert IR.default_event_info() == JIR.default_event_info()
    kw = dict(edit_text="drop a ball", insert_object_info=[obj],
              rb_transform={"a": {"0": {"pos": [0, 0, 1], "rot": [0, 0, 0],
                                        "scale": [1, 1, 1]}}})
    p, jp = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    IR.EditConfig(**kw).to_json(p)
    JIR.EditConfig(**kw).to_json(jp)
    with open(p) as a, open(jp) as b:
        assert a.read() == b.read()
    assert JIR.EditConfig.from_json(p) == JIR.EditConfig.from_json(jp)
    back = IR.EditConfig.from_json(jp)
    assert back.insert_object_info[0]["pos"] == [1.0, 2.0, 3.0]


def test_event_schedules_equal():
    rng = np.random.default_rng(4)
    ids = ["a", "b", "c"]
    objects = [{"object_id": i, "rigid_body": {"rb_type": t}}
               for i, t in zip(ids, ("ACTIVE", "PASSIVE", "active"))]
    events = [{"object_id": ids[rng.integers(3)],
               "event_type": EV.EVENT_TYPES[rng.integers(6)],
               "start_frame": int(rng.integers(1, 12)),
               "end_frame": (None if k % 3 == 0 else int(rng.integers(4, 20)))}
              for k in range(20)]
    events.append({"object_id": "zz", "event_type": "fire"})
    for frames in (1, 10, 24):
        got = EV.compile_event_schedule(events, ids, frames)
        want = JEV.compile_event_schedule(events, ids, frames)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(
            EV.physics_enabled_schedule(objects, events, frames),
            JEV.physics_enabled_schedule(objects, events, frames))


def test_fracture_pieces_equal():
    v, f, _ = sphere_mesh(colors=False)
    got = FR.fracture_mesh(v * 0.4, f, num_pieces=6, surface_samples=3000)
    want = JFR.fracture_mesh(v * 0.4, f, num_pieces=6, surface_samples=3000)
    assert len(got.vertices) == len(want.vertices) == 6
    for a, b in zip(got.vertices + got.faces, want.vertices + want.faces):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.mass_fractions, want.mass_fractions)
    lin = np.array([0.1, 0.0, -1.0])
    ang = np.array([0.0, 2.0, 0.0])
    np.testing.assert_array_equal(
        FR.burst_velocities(got, lin, ang, np.zeros(3)),
        JFR.burst_velocities(want, lin, ang, np.zeros(3)))


def test_decimate_equal_on_int64_faces():
    v, f, _ = sphere_mesh(24, 32, colors=False)
    got = DEC.decimate_quadric(v, f, 120)
    want = JDEC.decimate_quadric(v, f, 120)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) <= 120
    np.testing.assert_array_equal(DEC._edges_of(f), JDEC._edges_of(f))


def test_decimate_edges_of_int32_faces_where_the_reference_fails():
    """The reference's ``_edges_of`` packs (a << 32) | b in the faces'
    own dtype (``sugar/decimate.py:44``): for int32 faces the shift
    leaves only b, and numpy 2 then refuses its 0xFFFFFFFF mask for
    int32.  The port casts to int64 first and returns the int64 faces'
    edges."""
    _, f, _ = sphere_mesh(colors=False)
    f32 = f.astype(np.int32)
    np.testing.assert_array_equal(DEC._edges_of(f32), DEC._edges_of(f))
    with pytest.raises(OverflowError):
        JDEC._edges_of(f32)


def _ring(pkg, n=5, w=64, h=48):
    return pkg.stack_cameras([
        pkg.look_at_camera([3 * np.cos(a), 3 * np.sin(a), 1.6], [0, 0, 0],
                           [0, 0, 1], fx=50.0, fy=52.0, width=w, height=h,
                           **({"device": "cpu"} if pkg is C else {}))
        for a in np.linspace(0, np.pi, n)])


@pytest.mark.parametrize("downscale", [1.0, 2.0])
def test_trajectory_json_across_packages(tmp_path, downscale):
    jp, tp = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    JC.save_custom_trajectory(jp, _ring(JC))
    C.save_custom_trajectory(tp, _ring(C))
    with open(jp) as a, open(tp) as b:
        assert a.read() == b.read()
    got, c2w, names = C.load_custom_trajectory(jp, downscale, device="cpu")
    want, j_c2w, j_names = JC.load_custom_trajectory(tp, downscale)
    assert names == j_names and (got.width, got.height) == (
        want.width, want.height)
    np.testing.assert_array_equal(c2w, j_c2w)
    for f in ("R", "t", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6)
    assert C.fov2focal(0.9, 64) == JC.fov2focal(0.9, 64)
    assert C.focal2fov(50.0, 64) == JC.focal2fov(50.0, 64)
    np.testing.assert_array_equal(C.opencv_to_opengl_c2w(c2w[0]),
                                  JC.opencv_to_opengl_c2w(c2w[0]))
    np.testing.assert_array_equal(C.opengl_to_opencv_c2w(c2w[0]),
                                  JC.opengl_to_opencv_c2w(c2w[0]))


@pytest.fixture(scope="module")
def splats():
    g = make_gaussians(300, jax.random.PRNGKey(5), spread=1.0)
    return g.replace(active=jnp.arange(300) % 7 != 0)


def same_splats(got, want, tol=0.0):
    for f in convert.GAUSSIAN_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=tol, err_msg=f)


def test_load_gaussians_ply_and_npz(tmp_path, splats):
    ply = str(tmp_path / "g.ply")
    JPLY.save_ply(ply, splats)
    same_splats(PLY.load_gaussians(ply, device="cpu"), JPLY.load_gaussians(ply))
    jnpz, tnpz = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JPLY.save_npz(jnpz, splats)
    got = PLY.load_gaussians(jnpz, device="cpu")
    same_splats(got, splats)
    PLY.save_npz(tnpz, got)
    same_splats(PLY.load_npz(tnpz, device="cpu"), JPLY.load_npz(tnpz))


@pytest.mark.parametrize("nested", [False, True])
def test_load_gaussians_sugar_pt(tmp_path, splats, nested):
    n = splats.capacity
    t = lambda x: torch.tensor(np.asarray(x))
    sd = {"_points": t(splats.xyz),
          "all_densities": t(splats.opacity_logit)[:, None],
          "_sh_coordinates_dc": t(splats.sh_dc)[:, None, :],
          "_sh_coordinates_rest": t(splats.sh_rest),
          "_scales": t(splats.log_scales),
          "_quaternions": t(splats.quats)}
    path = str(tmp_path / "sugar.pt")
    torch.save({"state_dict": sd} if nested else sd, path)
    got = PLY.load_gaussians(path, device="cpu")
    assert got.capacity == n and bool(got.active.all())
    same_splats(got, JPLY.load_gaussians(path))
    with pytest.raises(ValueError):
        PLY.load_gaussians(str(tmp_path / "g.bin"), device="cpu")


def test_covariance_matches_jax(splats):
    g = convert.gaussians({f: np.asarray(getattr(splats, f))
                           for f in convert.GAUSSIAN_FIELDS}, device="cpu")
    for mod in (1.0, 0.5):
        np.testing.assert_allclose(g.covariance(mod).numpy(),
                                   np.asarray(splats.covariance(mod)),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("rotate_sh", [False, True])
@pytest.mark.parametrize("pivot", [None, (0.1, -0.2, 0.3)])
def test_transformed_matches_jax(splats, rotate_sh, pivot):
    g = convert.gaussians({f: np.asarray(getattr(splats, f))
                           for f in convert.GAUSSIAN_FIELDS}, device="cpu")
    q = np.array([0.9, 0.1, -0.3, 0.2], np.float32)
    q /= np.linalg.norm(q)
    tr = np.array([0.5, -1.0, 0.25], np.float32)
    kw = dict(scale=1.7, rotate_sh=rotate_sh)
    got = g.transformed(rotation_quat=torch.tensor(q),
                        translation=torch.tensor(tr),
                        pivot=None if pivot is None else torch.tensor(pivot),
                        **kw)
    want = splats.transformed(rotation_quat=jnp.asarray(q),
                              translation=jnp.asarray(tr),
                              pivot=None if pivot is None
                              else jnp.asarray(pivot), **kw)
    same_splats(got, want, TOL)


def test_sh_rotation_matches_jax():
    rot = Q.quat_to_rotmat(torch.tensor([0.8, 0.2, 0.5, -0.26])).numpy()
    rot = np.linalg.qr(rot.astype(np.float64))[0].astype(np.float32)
    np.testing.assert_allclose(SHR.sh_rotation_matrix(rot),
                               JSHR.sh_rotation_matrix(rot), rtol=0, atol=TOL)
    coeffs = np.random.default_rng(6).normal(size=(50, 16, 3)).astype(
        np.float32)
    np.testing.assert_allclose(SHR.rotate_sh(torch.tensor(coeffs), rot),
                               np.asarray(JSHR.rotate_sh(jnp.asarray(coeffs),
                                                         rot)),
                               rtol=0, atol=TOL)
    # a rotation of the coefficients equals a rotation of the directions
    from autovfx_tpu_torch.core.sh import eval_sh

    d = torch.nn.functional.normalize(torch.randn(20, 3), dim=-1)
    c = torch.tensor(coeffs[:1]).expand(20, 16, 3)
    rotated = SHR.rotate_sh(c, rot)
    np.testing.assert_allclose(
        eval_sh(3, rotated, d @ torch.tensor(rot).T).numpy(),
        eval_sh(3, c, d).numpy(), rtol=0, atol=1e-4)


def test_load_emitter_matches_jax(tmp_path):
    v = np.array([[-0.3, -0.3, 1.2], [0.3, -0.3, 1.2], [0.3, 0.3, 1.2],
                  [-0.3, 0.3, 1.3]], np.float32)
    path = str(tmp_path / "emitter.obj")
    MIO.save_obj(path, MIO.Mesh(v, np.array([[0, 1, 2], [0, 2, 3]])))
    got = EM.load_emitter(path, num_samples=64, strength=4.0,
                          color=(1.0, 0.9, 0.8), seed=3, device="cpu")
    want = JEM.load_emitter(path, num_samples=64, strength=4.0,
                            color=(1.0, 0.9, 0.8), seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
