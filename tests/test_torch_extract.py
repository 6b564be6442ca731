"""The port's detect -> extract chain against the JAX package's, on the
CPU, on ``tests/test_edit.py``'s extraction scene (a box on a ground
quad, 300 ground splats and 150 in the box, 3 views at 64×48, DEVA
masks rendered from the box's splats alone and written as PNGs).

- ``extract_object_from_scene``: the same triangles (object and removal
  meshes equal) and the same splat split (both PLYs equal), also from
  masks at twice the render size, which both resize as the image
  library's bicubic filter does (the port on the device, bit for bit);
- ``detect_object``: the same object dict but for its random id;
- ``get_largest_object``, ``merge_instances`` and a seeded
  ``sample_point_on_object``: equal results.
"""
import os
import random
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from PIL import Image

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.core import ply_io as JPLY
from autovfx_tpu.core.gaussians import merge
from autovfx_tpu.edit import edit_utils as JEU
from autovfx_tpu.edit import mesh_io as JMIO
from autovfx_tpu.edit.scene_representation import SceneParams as JParams
from autovfx_tpu.edit.scene_representation import (
    SceneRepresentation as JScene,
)
from autovfx_tpu.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu.perception import extract as JEX
from autovfx_tpu.perception import wrappers as JW
from autovfx_tpu.utils.synthetic import make_gaussians
from autovfx_tpu_torch.edit import edit_utils as EU
from autovfx_tpu_torch.edit.scene_representation import (
    SceneParams,
    SceneRepresentation,
)
from autovfx_tpu_torch.perception import extract as EX
from autovfx_tpu_torch.perception import wrappers as W


def box_mesh(half=0.5):
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int64)
    return v, f


def write_scene(root: str) -> dict:
    """``tests/test_edit.py:280-365``'s files: scene mesh, splats,
    trajectory; returns the SceneParams keywords and the box splats'
    masks' renderer."""
    gv = np.array([[-6, -6, 0], [6, -6, 0], [6, 6, 0], [-6, 6, 0]],
                  np.float32)
    gf = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    bv, bf = box_mesh(0.5)
    bv = bv + np.array([0, 0, 0.5], np.float32)
    mesh_path = os.path.join(root, "scene_mesh.obj")
    JMIO.save_obj(mesh_path, JMIO.Mesh(
        vertices=np.concatenate([gv, bv]), faces=np.concatenate([gf, bf + 4])))
    g_ground = make_gaussians(300, jax.random.PRNGKey(0), spread=2.0)
    g_ground = g_ground.replace(xyz=g_ground.xyz.at[:, 2].set(
        jnp.abs(g_ground.xyz[:, 2]) * 0.01))
    g_obj = make_gaussians(150, jax.random.PRNGKey(1), spread=0.22)
    g_obj = g_obj.replace(xyz=g_obj.xyz + jnp.array([0, 0, 0.5]))
    g = merge(g_ground, g_obj)
    JPLY.save_ply(os.path.join(root, "scene.ply"), g)
    cams = JC.stack_cameras([
        JC.look_at_camera([2.5 * np.cos(a), 2.5 * np.sin(a), 1.6],
                          [0, 0, 0.4], [0, 0, 1], fx=60.0, fy=60.0,
                          width=64, height=48)
        for a in np.linspace(0, np.pi, 3)])
    JC.save_custom_trajectory(
        os.path.join(root, "custom_camera_path", "t.json"), cams)
    params = dict(source_path=root, model_path=root,
                  gaussians_ckpt_path=os.path.join(root, "scene.ply"),
                  scene_mesh_path=mesh_path, custom_traj_name="t",
                  dup_budget=1 << 14)
    return params, g, cams


def write_masks(tdir: str, g, cams, active, threshold=0.4):
    """The alpha of the splats in ``active`` through each view, > 0.4,
    as 8-bit PNGs (``tests/test_edit.py:353-365``)."""
    os.makedirs(tdir, exist_ok=True)
    cfg = RasterConfig(dup_budget=1 << 14, backend="ref")
    for i in range(JC.num_cameras(cams)):
        out = rasterize(g.replace(active=jnp.asarray(active)),
                        JC.index_camera(cams, i), config=cfg)
        mask = (np.asarray(out.alpha) > threshold) * 255
        Image.fromarray(mask.astype(np.uint8)).save(
            os.path.join(tdir, f"{i:05d}.png"))


def port_scene(params, cache):
    return SceneRepresentation(SceneParams(cache_dir=cache, device="cpu",
                                           **params))


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("extract"))
    params, g, cams = write_scene(root)
    js = JScene(JParams(cache_dir=os.path.join(root, "jax_cache"), **params))
    ts = port_scene(params, os.path.join(root, "port_cache"))
    box_only = np.arange(g.capacity) >= 300
    for scene in (js, ts):
        write_masks(os.path.join(scene.tracking_results_dir, "box", "1"),
                    g, cams, box_only)
    want = JEX.extract_object_from_scene(js, "box", 1)
    got = EX.extract_object_from_scene(ts, "box", 1)
    return dict(root=root, params=params, g=g, cams=cams, js=js, ts=ts,
                want=want, got=got)


def _meshes(path):
    base = os.path.dirname(os.path.dirname(path))
    return [JMIO.load_mesh(p) for p in (
        path, os.path.join(base, "removal_mesh", "removal_mesh.obj"))]


def test_extraction_selects_the_same_triangles(extracted):
    got, want = extracted["got"], extracted["want"]
    assert os.path.relpath(got, extracted["ts"].cache_dir) == \
        os.path.relpath(want, extracted["js"].cache_dir)
    for a, b in zip(_meshes(got), _meshes(want)):
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_array_equal(a.vertices, b.vertices)
    obj = _meshes(got)[0]
    assert len(obj.faces) > 0 and obj.vertices[:, 2].max() > 0.5
    assert np.abs(obj.vertices[:, :2]).max() < 1.5


@pytest.mark.parametrize("part", ["object", "removal"])
def test_extraction_splits_the_same_splats(extracted, part):
    name = f"{part}_gaussians.ply"
    base = lambda p: os.path.dirname(os.path.dirname(p))
    with open(os.path.join(base(extracted["got"]), name), "rb") as f:
        got = f.read()
    with open(os.path.join(base(extracted["want"]), name), "rb") as f:
        want = f.read()
    assert got == want
    if part == "object":
        xyz = np.asarray(JPLY.load_ply(
            os.path.join(base(extracted["got"]), name)).xyz)
        assert (np.linalg.norm(xyz - [0, 0, 0.5], axis=1) < 0.8).mean() > 0.7


@pytest.mark.parametrize("src,dst", [
    ((96, 128), (48, 64)), ((97, 131), (48, 64)), ((48, 64), (96, 128)),
    ((100, 100), (33, 77)), ((30, 40), (47, 13)),
])
def test_mask_resize_matches_the_image_library(src, dst):
    """Random, elliptic and striped masks, down, up and mixed."""
    h, w = src
    yy, xx = np.mgrid[:h, :w]
    masks = [np.random.default_rng(h * w).random(src) > 0.5,
             (yy - h / 2) ** 2 / (h / 3) ** 2 + (xx - w / 2) ** 2
             / (w / 4) ** 2 < 1,
             (xx + 2 * yy) % 7 < 3]
    for m in masks:
        want = np.asarray(Image.fromarray(m.astype(np.uint8) * 255).resize(
            dst[::-1])) > 127
        got = EX._resize_mask(m, *dst, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_extraction_from_masks_at_twice_the_render_size_matches_jax(
        extracted):
    """The DEVA masks at 128×96 for the 64×48 views: both packages resize
    them before the vote and the sweep, and pick the same triangles and
    splats."""
    root, g, params = extracted["root"], extracted["g"], extracted["params"]
    cams2 = JC.stack_cameras([
        JC.look_at_camera([2.5 * np.cos(a), 2.5 * np.sin(a), 1.6],
                          [0, 0, 0.4], [0, 0, 1], fx=120.0, fy=120.0,
                          width=128, height=96)
        for a in np.linspace(0, np.pi, 3)])
    js = JScene(JParams(cache_dir=os.path.join(root, "jax_cache2"),
                        **params))
    ts = port_scene(params, os.path.join(root, "port_cache2"))
    box_only = np.arange(g.capacity) >= 300
    for scene in (js, ts):
        write_masks(os.path.join(scene.tracking_results_dir, "box", "1"),
                    g, cams2, box_only)
    want = JEX.extract_object_from_scene(js, "box", 1)
    got = EX.extract_object_from_scene(ts, "box", 1)
    for a, b in zip(_meshes(got), _meshes(want)):
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_array_equal(a.vertices, b.vertices)
    assert len(_meshes(got)[0].faces) > 0
    base = lambda p: os.path.dirname(os.path.dirname(p))
    for name in ("object_gaussians.ply", "removal_gaussians.ply"):
        with open(os.path.join(base(got), name), "rb") as f, \
                open(os.path.join(base(want), name), "rb") as h:
            assert f.read() == h.read()


def test_detect_object_matches_jax(extracted):
    js, ts = extracted["js"], extracted["ts"]
    got = EU.detect_object(ts, "box")
    want = JEU.detect_object(js, "box")
    assert len(got.pop("object_id")) == len(want.pop("object_id")) == 16
    for k in ("object_path", "gaussians_path"):
        assert os.path.relpath(got.pop(k), ts.cache_dir) == \
            os.path.relpath(want.pop(k), js.cache_dir)
    np.testing.assert_array_equal(got.pop("pos"), want.pop("pos"))
    np.testing.assert_array_equal(got.pop("rot"), want.pop("rot"))
    assert got == want


def test_largest_object_matches_jax(extracted, tmp_path):
    """Three instances: the box (1), a smaller one (4), and a copy of the
    box (7) that ties it; both pick the first of the largest."""
    g, cams = extracted["g"], extracted["cams"]
    ids = np.arange(g.capacity)
    for scene in (extracted["js"], extracted["ts"]):
        tdir = os.path.join(scene.tracking_results_dir, "box")
        write_masks(os.path.join(tdir, "4"), g, cams,
                    (ids >= 300) & (ids < 340))
        shutil.copytree(os.path.join(tdir, "1"), os.path.join(tdir, "7"),
                        dirs_exist_ok=True)
    for order, first in (([1, 4, 7], 1), ([4, 7, 1], 7)):
        got = EX.get_largest_object(extracted["ts"], "box", order)
        want = JEX.get_largest_object(extracted["js"], "box", order)
        assert got == want == first


def test_merge_instances_matches_jax(extracted, tmp_path):
    """Two overlapping detections of the box (the upper and lower halves
    of its splats) and one apart (a ground patch) merge alike."""
    g, cams = extracted["g"], extracted["cams"]
    ids = np.arange(g.capacity)
    xyz = np.asarray(g.xyz)
    parts = {2: (ids >= 300) & (xyz[:, 2] > 0.5),
             5: (ids >= 300) & (xyz[:, 2] <= 0.5),
             9: (ids < 300) & (xyz[:, 0] > 1.2)}
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = str(tmp_path / pkg)
        for i, active in parts.items():
            write_masks(os.path.join(dirs[pkg], str(i)), g, cams, active,
                        threshold=0.05)
    want = JW.merge_instances(dirs["jax"])
    got = W.merge_instances(dirs["port"])
    assert got == want and 7 in got
    for i in got:
        np.testing.assert_array_equal(W.load_instance_masks(dirs["port"], i),
                                      JW.load_instance_masks(dirs["jax"], i))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_point_on_object_matches_jax_under_a_seed(extracted, seed):
    ts, js = extracted["ts"], extracted["js"]
    obj = {"object_path": extracted["got"], "object_name": "box",
           "object_id": "box1"}
    random.seed(seed)
    want = JEU.sample_point_on_object(js, dict(obj,
                                               object_path=extracted["want"]))
    random.seed(seed)
    got = EU.sample_point_on_object(ts, obj)
    np.testing.assert_array_equal(got, want)
    random.seed(seed)
    above = EU.sample_point_above_object(ts, obj)
    np.testing.assert_allclose(above, got + [0, 0, 0.6], rtol=0, atol=1e-6)


def test_single_view_extraction_matches_jax(extracted):
    js, ts = extracted["js"], extracted["ts"]
    mask = W.load_instance_masks(
        os.path.join(ts.tracking_results_dir, "box"), 1)[0]
    got = EX.extract_object_from_single_view(ts, "box", mask)
    want = JEX.extract_object_from_single_view(js, "box", mask)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_missing_masks_raise(extracted, tmp_path):
    with pytest.raises(W.PrecomputedInputMissing):
        W.run_deva(str(tmp_path), str(tmp_path), "no such thing")
    with pytest.raises(W.PrecomputedInputMissing):
        W.load_instance_masks(str(tmp_path), 3)
