"""The port's dataset tooling against the JAX package's, on the CPU.

The readers on the fixtures of ``tests/test_dataset_tools.py`` and
``tests/test_dataset.py`` (equal), the alignment (equal: the same
seeded numpy), ``normals_from_depth`` on a rendered depth (1e-5, the
border rows included), the mono-normal PNGs and their priority,
re-triangulation on the same renders (points and colours equal), the
scene scale (rel 1e-4) and the trajectories (1e-6).
"""
import json
import sqlite3
import struct

import numpy as np
import jax
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.dataset import alignment as JAL
from autovfx_tpu.dataset import mono_normal as JMN
from autovfx_tpu.dataset import readers as JRD
from autovfx_tpu.dataset import retriangulate as JRT
from autovfx_tpu.dataset import scene_scale as JSS
from autovfx_tpu.dataset import trajectories as JTR
from autovfx_tpu.edit.mesh_io import Mesh as JMesh
from autovfx_tpu.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu.utils.synthetic import make_gaussians
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.dataset import alignment as AL
from autovfx_tpu_torch.dataset import mono_normal as MN
from autovfx_tpu_torch.dataset import readers as RD
from autovfx_tpu_torch.dataset import retriangulate as RT
from autovfx_tpu_torch.dataset import scene_scale as SS
from autovfx_tpu_torch.dataset import trajectories as TR
from autovfx_tpu_torch.edit.mesh_io import Mesh

CFG = RasterConfig(dup_budget=1 << 15, backend="ref")


def port_camera(cam):
    return convert.camera(
        {f: (np.asarray(getattr(cam, f)) if f not in ("width", "height")
             else getattr(cam, f)) for f in convert.CAMERA_FIELDS},
        device="cpu")


# ---- readers: the fixtures of the JAX tests -----------------------------------


def _tnt(tmp_path):
    d = tmp_path / "Playground"
    (d / "pose").mkdir(parents=True)
    for i, t in enumerate(([1.0, 2.0, 3.0], [0.5, -1.0, 2.0])):
        c2w = np.eye(4)
        c2w[:3, :3] = JAL.rodrigues(np.array([0.2, 0.5, 1.0]), 0.3 * i)
        c2w[:3, 3] = t
        np.savetxt(d / "pose" / f"00000{i + 1}.txt", c2w)
    np.savetxt(d / "intrinsics.txt", np.diag([500.0, 500.0, 1.0]))
    return str(d)


def _transforms(tmp_path, scene):
    d = tmp_path / scene
    d.mkdir()
    gl = np.eye(4)
    gl[:3, 3] = [0.5, 0.0, 1.0]
    gl2 = np.eye(4)
    gl2[:3, :3] = JAL.rodrigues(np.array([1.0, 0.0, 0.2]), 0.4)
    meta = {
        "fl_x": 400.0, "fl_y": 410.0, "cx": 320.0, "cy": 240.0,
        "w": 640, "h": 480,
        "frames": [
            {"file_path": "images/b.png", "transform_matrix": gl.tolist()},
            {"file_path": "images/a.png", "transform_matrix": gl2.tolist()},
        ],
    }
    (d / "transforms.json").write_text(json.dumps(meta))
    return str(d)


def _colmap_360(tmp_path):
    d = tmp_path / "garden"
    sparse = d / "sparse" / "0"
    sparse.mkdir(parents=True)
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 3))
        for i, (name, q, t) in enumerate([
                ("im2.png", [1.0, 0.0, 0.0, 0.0], [0, 0, 0]),
                ("im1.png", [0.9, 0.1, -0.3, 0.2], [2.0, 0, 0]),
                ("im3.png", [0.7, -0.2, 0.1, 0.6], [0.5, 1.5, -1.0])]):
            q = np.asarray(q) / np.linalg.norm(q)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *[float(x) for x in t]))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<i", 1))  # PINHOLE
        f.write(struct.pack("<QQ", 640, 480))
        f.write(struct.pack("<4d", 400.0, 400.0, 320.0, 240.0))
    return str(d)


def _scannetpp(tmp_path):
    d = tmp_path / "scene"
    (d / "dslr" / "colmap").mkdir(parents=True)
    (d / "dslr" / "nerfstudio").mkdir(parents=True)
    (d / "dslr" / "colmap" / "images.txt").write_text(
        "# comment\n"
        "1 1 0 0 0 0.5 0 0 1 img2.jpg\n"
        "1 2 3\n"
        "2 0.9 0.1 0.3 0.3 0 0.2 0 1 img1.jpg\n"
        "4 5 6\n"
    )
    (d / "dslr" / "nerfstudio" / "transforms_undistorted.json").write_text(
        json.dumps({"fl_x": 300.0, "fl_y": 300.0, "cx": 100.0, "cy": 90.0,
                    "w": 200, "h": 180}))
    return str(d)


READER_FIXTURES = {
    "tnt": _tnt,
    "360": _colmap_360,
    "lerf": lambda p: _transforms(p, "dozer_nerfgun_waldo"),
    "nerfstudio": lambda p: _transforms(p, "capture"),
    "scannetpp": _scannetpp,
}


@pytest.mark.parametrize("kind", sorted(READER_FIXTURES))
def test_reader_equals_jax(kind, tmp_path):
    d = READER_FIXTURES[kind](tmp_path)
    want = JRD.read_dataset(d, kind)
    got = RD.read_dataset(d, kind)
    assert got.names == want.names
    np.testing.assert_array_equal(got.c2w, want.c2w)
    np.testing.assert_array_equal(got.K, want.K)
    if want.img_wh is None:
        assert got.img_wh is None
    else:
        np.testing.assert_array_equal(got.img_wh, want.img_wh)
    # the port's cameras hold the poses and intrinsics
    cams = RD.to_cameras(got, 64, 48, device="cpu")
    assert C.num_cameras(cams) == len(got.names)
    np.testing.assert_allclose(cams.c2w[:, :3].numpy(), got.c2w, atol=1e-5)
    np.testing.assert_allclose(cams.fx.numpy(), got.K[0, 0])
    np.testing.assert_allclose(cams.cy.numpy(), got.K[1, 2])
    w, h = (64, 48) if got.img_wh is None else tuple(got.img_wh)
    assert (cams.width, cams.height) == (w, h)


def test_reader_tables_and_refusals(tmp_path):
    assert RD.SCENE_UP_VECTORS == JRD.SCENE_UP_VECTORS
    d = _tnt(tmp_path)
    with pytest.raises(ValueError):
        RD.read_dataset(d, "nope")
    with pytest.raises(ValueError, match="width and height"):
        RD.to_cameras(RD.read_tnt(d), device="cpu")


# ---- alignment ----------------------------------------------------------------


def test_alignment_equals_jax():
    rng = np.random.RandomState(0)
    true_n = np.array([0.1, 0.2, 0.97])
    true_n /= np.linalg.norm(true_n)
    normals = np.concatenate([true_n[None] + 0.01 * rng.randn(900, 3),
                              rng.randn(100, 3)])
    for kw in ({"sample_size": 500}, {"iters": 7, "seed": 3}):
        np.testing.assert_array_equal(AL.ransac_mean_normal(normals, **kw),
                                      JAL.ransac_mean_normal(normals, **kw))
    for up in ([0.3, -0.4, 0.85], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0],
               JRD.SCENE_UP_VECTORS["360"]["garden"]):
        np.testing.assert_array_equal(AL.up_alignment_rotation(np.array(up)),
                                      JAL.up_alignment_rotation(np.array(up)))
    np.testing.assert_array_equal(AL.rodrigues(np.array([1.0, 2.0, 0.5]), 0.7),
                                  JAL.rodrigues(np.array([1.0, 2.0, 0.5]), 0.7))
    c2ws = np.tile(np.eye(4), (10, 1, 1))
    c2ws[:, :3, 3] = np.random.RandomState(1).randn(10, 3) * 5 + 100.0
    c2ws[:, :3, :3] = JAL.rodrigues(np.array([0.3, 1.0, 0.1]), 0.5)
    for up in (None, np.array([0.1, -0.9, -0.4])):
        for a, b in zip(AL.normalize_poses(c2ws, up),
                        JAL.normalize_poses(c2ws, up)):
            np.testing.assert_array_equal(a, b)


# ---- mono normals -------------------------------------------------------------


@pytest.fixture(scope="module")
def rendered():
    """A 96×64 view of an 800-splat scene and its depth, by JAX."""
    g = make_gaussians(800, jax.random.PRNGKey(0), spread=0.6)
    cam = JC.look_at_camera([2.0, 0.4, 0.8], [0, 0, 0], [0, 0, 1], fx=60.0,
                            fy=62.0, width=96, height=64)
    out = rasterize(g, cam, config=CFG)
    return cam, np.array(out.depth)


def test_normals_from_depth_match_jax(rendered):
    cam, depth = rendered
    want = JMN.normals_from_depth(depth, cam)
    got = MN.normals_from_depth(torch.from_numpy(depth), port_camera(cam))
    assert got.shape == want.shape == (64, 96, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the one-sided border, where a difference is missing, is zero
    for edge in (got[0], got[-1], got[:, 0], got[:, -1]):
        assert float(edge.abs().max()) == 0.0
    inner = got[1:-1, 1:-1]
    norms = torch.linalg.norm(inner, dim=-1)
    lit = norms > 0.5
    assert float(lit.float().mean()) > 0.5
    np.testing.assert_allclose(norms[lit].numpy(), 1.0, atol=1e-5)
    assert float(inner[..., 2].max()) <= 0.0  # inward: toward the camera


def test_normal_pngs_and_priority(tmp_path, rendered):
    n = np.random.RandomState(0).randn(16, 16, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    mine, theirs = str(tmp_path / "p_normal.png"), str(tmp_path / "j_normal.png")
    MN.save_normal_map(mine, n)
    JMN.save_normal_map(theirs, n)
    # each package reads the other's file as its own
    np.testing.assert_array_equal(MN.load_normal_map(theirs),
                                  JMN.load_normal_map(mine))
    np.testing.assert_array_equal(MN.load_normal_map(mine),
                                  JMN.load_normal_map(mine))

    cam, depth = rendered
    names = ["a.png", "b.png"]
    MN.save_normal_map(MN.normal_map_path(str(tmp_path), "a.png"), n)
    with pytest.raises(MN.PrecomputedNormalsMissing):
        MN.get_mono_normals(names, str(tmp_path), device="cpu")
    jcams = JC.stack_cameras([cam, cam])
    depths = np.stack([depth, depth])
    n = np.zeros((64, 96, 3))
    n[..., 2] = -1.0
    MN.save_normal_map(MN.normal_map_path(str(tmp_path), "a.png"), n)
    got = MN.get_mono_normals(names, str(tmp_path), depths=depths,
                              cams=port_camera(jcams), device="cpu")
    want = JMN.get_mono_normals(names, str(tmp_path), depths=depths,
                                cams=jcams)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---- re-triangulation -----------------------------------------------------------


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """Four 192×144 renders of the JAX tests' 800-splat scene as PNGs."""
    from PIL import Image

    g = make_gaussians(800, jax.random.PRNGKey(0), spread=0.6)
    cams = JC.stack_cameras([
        JC.look_at_camera([2.0 * np.cos(a), 2.0 * np.sin(a), 0.8], [0, 0, 0],
                          [0, 0, 1], fx=90.0, fy=90.0, width=192, height=144)
        for a in np.linspace(0.0, 0.5, 4)])
    d = tmp_path_factory.mktemp("views")
    names = []
    for i in range(4):
        img = np.asarray(rasterize(g, JC.index_camera(cams, i),
                                   config=CFG).color)
        names.append(f"{i:05}.png")
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            d / names[-1])
    return str(d), cams, names


def test_model_text_equals_jax(tmp_path, views):
    _, cams, names = views
    pc = port_camera(cams)
    RT.write_cameras_txt(pc, str(tmp_path / "p_cameras.txt"))
    JRT.write_cameras_txt(cams, str(tmp_path / "j_cameras.txt"))
    assert ((tmp_path / "p_cameras.txt").read_text()
            == (tmp_path / "j_cameras.txt").read_text())
    RT.write_images_txt(pc, names, str(tmp_path / "p_images.txt"))
    JRT.write_images_txt(cams, names, str(tmp_path / "j_images.txt"))
    p = (tmp_path / "p_images.txt").read_text().split("\n")
    j = (tmp_path / "j_images.txt").read_text().split("\n")
    assert len(p) == len(j)
    assert [a for a in p if not a] == [b for b in j if not b]  # blank
    p, j = [a for a in p if a], [b for b in j if b]  # lines of 2D points
    assert len(p) == 1 + len(names)
    for a, b in zip(p[1:], j[1:]):
        a, b = a.split(), b.split()
        assert (a[0], a[8:]) == (b[0], b[8:])
        np.testing.assert_allclose(np.float64(a[1:8]), np.float64(b[1:8]),
                                   atol=1e-6)


def _database(path, names):
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE cameras (camera_id INTEGER, model INTEGER, "
                 "width INTEGER, height INTEGER, params BLOB, "
                 "prior_focal_length INTEGER)")
    conn.execute("CREATE TABLE images (image_id INTEGER, name TEXT, "
                 "camera_id INTEGER)")
    for i, name in enumerate(names + ["other.png"]):
        conn.execute("INSERT INTO cameras VALUES (?, 0, 1, 1, ?, 0)",
                     (i + 1, b""))
        conn.execute("INSERT INTO images VALUES (?, ?, ?)",
                     (i + 1, "sub/" + name, i + 1))
    conn.commit()
    conn.close()


def test_modify_database_equals_jax(tmp_path, views):
    _, cams, names = views
    rows = []
    for side, fn, c in (("p", RT.modify_database, port_camera(cams)),
                        ("j", JRT.modify_database, cams)):
        db = str(tmp_path / f"{side}.db")
        _database(db, names)
        fn(db, c, names)
        conn = sqlite3.connect(db)
        rows.append(conn.execute("SELECT * FROM cameras ORDER BY camera_id")
                    .fetchall())
        conn.close()
    assert rows[0] == rows[1]
    assert rows[0][0][1:4] == (1, 192, 144)  # PINHOLE at the image size
    assert rows[0][-1][1] == 0  # an image of no camera left alone


def test_native_triangulation_equals_jax(tmp_path, views):
    img_dir, cams, names = views
    want = JRT.triangulate_known_poses(img_dir, cams, names,
                                       str(tmp_path / "j"), use_colmap=False)
    got = RT.triangulate_known_poses(img_dir, port_camera(cams), names,
                                     str(tmp_path / "p"), use_colmap=False)
    assert len(got[0]) > 30
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with np.load(tmp_path / "p" / "points3d.npz") as f:
        np.testing.assert_array_equal(f["points"], want[0])


# ---- scene scale ------------------------------------------------------------------


def _box(lo, hi):
    v = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                  for z in (lo[2], hi[2])], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]])
    return v, f


def test_scene_scale_matches_jax():
    cam = JC.look_at_camera([2.5, 0.3, 1.2], [0, 0, 0.3], [0, 0, 1],
                            fx=80.0, fy=80.0, width=96, height=72)
    v1, f1 = _box([-0.3, -0.3, 0.0], [0.3, 0.3, 0.5])
    v2, f2 = _box([-2.0, -2.0, -0.05], [2.0, 2.0, 0.0])
    verts = np.concatenate([v1, v2])
    faces = np.concatenate([f1, f2 + 8])
    masks = {}
    jj, ii = np.mgrid[0:72, 0:96]
    masks["chair"] = (np.abs(ii - 48) < 14) & (np.abs(jj - 34) < 12)
    masks["table"] = (np.abs(ii - 30) < 10) & (np.abs(jj - 50) < 8)
    masks["nothing known"] = np.zeros((72, 96), bool)
    pc = port_camera(cam)
    for name, m in masks.items():
        want = JSS.observed_object_extent(cam, m, JMesh(verts, faces))
        got = SS.observed_object_extent(pc, m, Mesh(verts, faces))
        np.testing.assert_allclose(got, want, rtol=1e-4)
    want = JSS.estimate_scene_scale(cam, JMesh(verts, faces), masks)
    got = SS.estimate_scene_scale(pc, Mesh(verts, faces), masks)
    assert want != 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---- trajectories ----------------------------------------------------------------


def _close(got, want):
    for f in ("R", "t", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6,
                                   rtol=0)
    assert (got.width, got.height) == (want.width, want.height)


def test_trajectories_match_jax(tmp_path):
    kw = dict(radius=2.0, height=1.5, num_frames=12, fx=100.0, fy=100.0,
              width=64, height_px=48)
    _close(TR.half_sphere_trajectory([0, 0, 0.5], device="cpu", **kw),
           JTR.half_sphere_trajectory([0, 0, 0.5], **kw))
    _close(TR.half_sphere_trajectory([0.1, 0.2, 0.3], 1.0, 0.5, 5,
                                     start_angle=0.3, sweep=1.0,
                                     device="cpu"),
           JTR.half_sphere_trajectory([0.1, 0.2, 0.3], 1.0, 0.5, 5,
                                      start_angle=0.3, sweep=1.0))
    # (the image height cannot be passed: it is the orbit's ``height``)
    _close(TR.lemniscate_trajectory([0, 0, 0.2], 1.5, 1.0, 9, device="cpu",
                                    fx=50.0, width=80),
           JTR.lemniscate_trajectory([0, 0, 0.2], 1.5, 1.0, 9, fx=50.0,
                                     width=80))
    assert TR.GARDEN_INTRINSICS == JTR.GARDEN_INTRINSICS
    # the file round-trips through both packages' loaders
    cams = TR.half_sphere_trajectory([0, 0, 0.5], device="cpu", **kw)
    path = str(tmp_path / "t.json")
    TR.save_trajectory(path, cams)
    back, c2w, names = C.load_custom_trajectory(path, device="cpu")
    _close(back, JC.load_custom_trajectory(path)[0])
    np.testing.assert_allclose(back.R.numpy(), cams.R.numpy(), atol=1e-6)
    assert names == [f"{i:05d}.png" for i in range(12)]
