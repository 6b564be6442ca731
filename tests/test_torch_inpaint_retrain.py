"""Object removal in the port against the JAX package, on the CPU: the
inpainting loss and step, the removal renders and their inpaints, the
retraining's output, and ``remove_object`` / ``update_object``.

- ``is_large_mask`` on hand-made masks, equal to JAX's;
- ``inpaint_loss`` with and without LPIPS on a 20k-splat 64×48 scene:
  the value at rtol 1e-5, each parameter gradient and the mean-2D
  gradient within 5e-4 of the field's largest against ``jax.grad``
  (the budgets of ``tests/test_torch_train.py``; JAX's loss jitted once
  per variant, the LPIPS one at this one shape since its VGG compiles
  per shape);
- one ``inpaint_step`` against JAX's step on the same camera: the loss
  and PSNR at rtol 1e-5, the visibility counts and radii exactly and the
  accumulated mean-2D gradient norms at that gradient's 5e-4;
- ``inpaint_object`` on hand-made extraction outputs of
  ``tests/test_torch_edit.py``'s scene (2 frames): the merged mesh
  exactly, the hole masks exactly, the inpainted PNGs within 1/255 where
  the holes agree (no LaMa checkpoint: both inpaint with OpenCV's
  TELEA), the poses JSON within 1e-6;
- a 4-iteration retraining writes ``inpaint_gaussians.ply`` from a state
  of the reference's capacity;
- ``remove_object`` with the JAX side's removal outputs as the cache
  (the reference's "exists" checks skip the work) swaps the mesh and
  reloads the same splats as JAX's; ``update_object`` keeps the splats
  of an object on fire and removes them otherwise.
"""
import copy
import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_edit import (  # noqa: E402
    JMIO,
    JPLY,
    box_mesh,
    jax_reference,
    scenes,
    write_scene,
)
from test_torch_train import (  # noqa: E402
    PARAMS,
    assert_field_close,
    port_camera,
    port_gaussians,
    t,
)
from autovfx_tpu.edit import edit_utils as JEU  # noqa: E402
from autovfx_tpu.edit.edit_ir import default_event_info  # noqa: E402
from autovfx_tpu.ops.rasterize import RasterConfig as JConfig  # noqa: E402
from autovfx_tpu.perception import extract as JEX  # noqa: E402
from autovfx_tpu.train import inpaint_retrain as JIR  # noqa: E402
from autovfx_tpu.train import trainer as JT  # noqa: E402
from autovfx_tpu.utils.synthetic import make_scene  # noqa: E402
from autovfx_tpu_torch.core import ply_io  # noqa: E402
from autovfx_tpu_torch.edit import edit_utils as EU  # noqa: E402
from autovfx_tpu_torch.edit import mesh_io  # noqa: E402
from autovfx_tpu_torch.ops.rasterize import RasterConfig  # noqa: E402
from autovfx_tpu_torch.perception import extract as EX  # noqa: E402
from autovfx_tpu_torch.train import inpaint_retrain as IR  # noqa: E402
from autovfx_tpu_torch.train import trainer as T  # noqa: E402
from autovfx_tpu_torch.utils import png  # noqa: E402

BUDGET = 1 << 17
W, H = 64, 48


@pytest.mark.parametrize("mask,large", [
    (np.zeros((48, 64), bool), False),
    (np.pad(np.ones((33, 33), bool), ((5, 10), (7, 24))), True),
    (np.pad(np.ones((32, 33), bool), ((5, 11), (7, 24))), False),
    (np.pad(np.ones((4, 60), bool), ((20, 24), (2, 2))), False),
])
def test_is_large_mask_matches_jax(mask, large):
    assert IR.is_large_mask(mask) is large
    assert bool(JIR.is_large_mask(mask)) is large


@pytest.fixture(scope="module")
def loss_case():
    """A 20k-splat 64×48 scene, a target, a hole, and JAX's jitted value
    and gradients of its ``inpaint_loss`` for each variant."""
    g, cam = make_scene(n=20_000, width=W, height=H, key=11)
    rng = np.random.default_rng(11)
    target = rng.random((H, W, 3), np.float32)
    mask = np.zeros((H, W), bool)
    mask[8:44, 10:50] = True
    jcfg = JT.TrainConfig(raster=JConfig(dup_budget=BUDGET, backend="ref"))
    cfg = T.TrainConfig(raster=RasterConfig(dup_budget=BUDGET))
    grads = {}
    for use_lpips in (False, True):
        def loss_fn(params, offset, use_lpips=use_lpips):
            return JIR.inpaint_loss(g.replace(**params), offset, cam,
                                    jnp.asarray(target), jnp.asarray(mask),
                                    jcfg, use_lpips)

        grads[use_lpips] = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(
            {f: getattr(g, f) for f in PARAMS},
            jnp.zeros((g.capacity, 2), jnp.float32))
    return dict(g=g, cam=cam, target=target, mask=mask, jcfg=jcfg, cfg=cfg,
                grads=grads)


@pytest.mark.parametrize("use_lpips", [False, True])
def test_inpaint_loss_and_gradients_match_jax(loss_case, use_lpips):
    c = loss_case
    (j_loss, (_, _, j_psnr)), (j_params, j_off) = c["grads"][use_lpips]
    gt = port_gaussians(c["g"])
    leaves = {f: getattr(gt, f).clone().requires_grad_(True) for f in PARAMS}
    offset = torch.zeros((gt.capacity, 2), requires_grad=True)
    loss, (_, overflow, psnr) = IR.inpaint_loss(
        dataclasses.replace(gt, **leaves), offset, port_camera(c["cam"]),
        t(c["target"]), t(c["mask"]), c["cfg"], use_lpips)
    assert not bool(overflow)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(psnr.detach()), float(j_psnr),
                               rtol=1e-5)
    loss.backward()
    for f in PARAMS:
        assert_field_close(leaves[f].grad.numpy(), j_params[f], 5e-4, f)
    assert_field_close(offset.grad.numpy(), j_off, 5e-4, "mean2d_offset")


def test_inpaint_step_matches_jax(loss_case):
    c = loss_case
    (j_loss, (j_radii, j_over, j_psnr)), (j_params, j_off) = \
        c["grads"][True]
    js = JT.init_state(c["g"])
    jstats = js.stats.update(j_off, j_radii, W, H)
    state, aux = IR.inpaint_step(T.init_state(port_gaussians(c["g"])),
                                 port_camera(c["cam"]), t(c["target"]),
                                 t(c["mask"]), c["cfg"], True)
    np.testing.assert_allclose(float(aux.loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(aux.psnr), float(j_psnr), rtol=1e-5)
    assert state.step == 1 and state.adam.count == 1
    assert bool(aux.overflow) == bool(j_over) is False
    np.testing.assert_array_equal(state.stats.max_radii.numpy(),
                                  np.asarray(jstats.max_radii))
    np.testing.assert_array_equal(state.stats.denom.numpy(),
                                  np.asarray(jstats.denom))
    # the norms of the mean-2D gradient, at that gradient's budget
    assert_field_close(state.stats.grad_accum.numpy(), jstats.grad_accum,
                       5e-4, "grad_accum")


def _extraction(js, ts):
    """The extraction's four outputs for a "box" (instance 1) of the
    scene, written into both caches: a box mesh at the origin, the
    ground as the removal mesh, and the splats outside the box's
    footprint as the removal splats."""
    bases = []
    for scene in (js, ts):
        base = os.path.join(scene.cache_dir, "extract", "box", "1")
        for sub in ("object_mesh", "removal_mesh"):
            os.makedirs(os.path.join(base, sub))
        JMIO.save_obj(os.path.join(base, "object_mesh", "object_mesh.obj"),
                      box_mesh(0.3))
        shutil.copy(scene.hparams.scene_mesh_path,
                    os.path.join(base, "removal_mesh", "removal_mesh.obj"))
        bases.append(base)
    g = js.gaussians
    inside = (jnp.abs(g.xyz[:, 0]) < 0.3) & (jnp.abs(g.xyz[:, 1]) < 0.3)
    for base in bases:
        JPLY.save_ply(os.path.join(base, "removal_gaussians.ply"),
                      g.replace(active=g.active & ~inside))
    JPLY.save_ply(os.path.join(bases[0], "object_gaussians.ply"),
                  g.replace(active=g.active & inside))
    return bases


@pytest.fixture(scope="module")
def removal(tmp_path_factory, monkeypatch_module):
    """``inpaint_object`` through both packages on the same extraction,
    with no LaMa checkpoint (OpenCV's TELEA in both)."""
    monkeypatch_module.delenv("AUTOVFX_LAMA_CKPT", raising=False)
    root = str(tmp_path_factory.mktemp("removal"))
    monkeypatch_module.setenv("HOME", root)
    params = write_scene(root, n_cams=2)
    js, ts = scenes(root, params)
    jbase, tbase = _extraction(js, ts)
    with jax_reference():
        JEX.inpaint_object(js, "box", 1)
    got = EX.inpaint_object(ts, "box", "1")
    assert got == tbase
    return dict(root=root, params=params, js=js, ts=ts, jbase=jbase,
                tbase=tbase)


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_inpaint_object_mesh_matches_jax(removal):
    sub = os.path.join("inpaint_removal_mesh", "inpaint_removal_mesh.obj")
    got = mesh_io.load_mesh(os.path.join(removal["tbase"], sub))
    want = JMIO.load_mesh(os.path.join(removal["jbase"], sub))
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    ground = mesh_io.load_mesh(removal["params"]["scene_mesh_path"])
    # the hull of the box's footprint: 4 corners fanned from the center
    assert len(got.faces) == len(ground.faces) + 4
    assert np.allclose(got.vertices[len(ground.vertices):, 2], -0.3)


def test_inpaint_object_views_match_jax(removal):
    from PIL import Image

    names = sorted(os.listdir(os.path.join(removal["jbase"],
                                           "render_inpaint_mask")))
    assert names == ["00000.png", "00001.png"]
    for name in names:
        got_m = png.read_mask(os.path.join(removal["tbase"],
                                           "render_inpaint_mask", name))
        want_m = np.asarray(Image.open(os.path.join(
            removal["jbase"], "render_inpaint_mask", name))) > 127
        np.testing.assert_array_equal(got_m, want_m)
        assert 0 < got_m.sum() < got_m.size
        got = png.read_png(os.path.join(removal["tbase"],
                                        "render_inpaint_lama", name))
        want = np.asarray(Image.open(os.path.join(
            removal["jbase"], "render_inpaint_lama", name)))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with open(os.path.join(removal["tbase"],
                           "inpaint_camera_poses.json")) as f:
        got = json.load(f)
    with open(os.path.join(removal["jbase"],
                           "inpaint_camera_poses.json")) as f:
        want = json.load(f)
    assert {k: v for k, v in got.items() if k != "frames"} == pytest.approx(
        {k: v for k, v in want.items() if k != "frames"})
    assert [fr["filename"] for fr in got["frames"]] == [
        fr["filename"] for fr in want["frames"]]
    np.testing.assert_allclose(
        [fr["transform_matrix"] for fr in got["frames"]],
        [fr["transform_matrix"] for fr in want["frames"]], atol=1e-6)


def test_retraining_writes_inpaint_gaussians(removal, tmp_path, monkeypatch):
    base, ts = removal["tbase"], removal["ts"]
    caps = []
    init = T.init_state

    def spy(g):
        caps.append(g.capacity)
        return init(g)

    monkeypatch.setattr(T, "init_state", spy)
    out = IR.training_3DGS_for_inpainting(
        ts, os.path.join(base, "removal_gaussians.ply"),
        os.path.join(base, "render_inpaint_lama"),
        os.path.join(base, "render_inpaint_mask"), str(tmp_path),
        os.path.join(base, "inpaint_camera_poses.json"), iterations=4,
        device="cpu")
    assert out == os.path.join(str(tmp_path), "inpaint_gaussians.ply")
    start = ply_io.load_gaussians(os.path.join(base, "removal_gaussians.ply"),
                                  device="cpu")
    assert caps == [max(int(1.5 * start.capacity), start.capacity + 1024)]
    g = ply_io.load_gaussians(out, device="cpu")
    assert g.capacity == start.capacity  # no densify in 4 iterations
    assert torch.isfinite(g.xyz).all() and not torch.equal(g.xyz, start.xyz)


@pytest.fixture()
def removed(removal, tmp_path):
    """Fresh scenes whose caches hold the JAX side's removal outputs and
    a stand-in ``inpaint_gaussians.ply`` (the removal splats as JAX wrote
    them), so neither package recomputes them; and the table object as
    ``detect_object`` would return it."""
    js, ts = scenes(str(tmp_path), removal["params"])
    for scene in (js, ts):
        base = os.path.join(scene.cache_dir, "extract", "box", "1")
        shutil.copytree(removal["jbase"], base)
        shutil.copy(os.path.join(base, "removal_gaussians.ply"),
                    os.path.join(base, "inpaint_gaussians.ply"))
    obj = {"object_name": "box", "object_id": "box1",
           "object_path": os.path.join(js.cache_dir, "extract", "box", "1",
                                       "object_mesh", "object_mesh.obj")}
    return js, ts, obj


def _port_obj(obj, ts, js):
    o = copy.deepcopy(obj)
    o["object_path"] = o["object_path"].replace(js.cache_dir, ts.cache_dir)
    return o


def test_remove_object_reloads_the_inpainted_scene(removed):
    js, ts, obj = removed
    JEU.remove_object(js, obj)
    EU.remove_object(ts, _port_obj(obj, ts, js))
    rel = lambda s: os.path.relpath(s.scene_mesh_path_for_blender, s.cache_dir)
    assert rel(ts) == rel(js) == os.path.join(
        "extract", "box", "1", "inpaint_removal_mesh",
        "inpaint_removal_mesh.obj")
    assert ts.hparams.gaussians_ckpt_path.endswith("inpaint_gaussians.ply")
    assert ts.gaussians.capacity == js.gaussians.capacity < 400
    np.testing.assert_array_equal(ts.gaussians.xyz.numpy(),
                                  np.asarray(js.gaussians.xyz))


@pytest.mark.parametrize("on_fire", [False, True])
def test_update_object_matches_jax(removed, on_fire):
    js, ts, obj = removed
    obj = dict(obj, **{k: v for k, v in EU.default_object_info().items()
                       if k not in obj})
    n0 = ts.gaussians.capacity
    for scene, dsl, o in ((js, JEU, obj), (ts, EU, _port_obj(obj, ts, js))):
        if on_fire:
            ev = default_event_info()
            ev.update(object_id=o["object_id"], event_type="fire")
            scene.events.append(ev)
        dsl.update_object(scene, copy.deepcopy(o))
    assert [o["object_id"] for o in ts.inserted_objects] == [
        o["object_id"] for o in js.inserted_objects] == ["box1"]
    assert ts.scene_mesh_path_for_blender.endswith(
        "inpaint_removal_mesh.obj")
    # an object on fire keeps its splats in the scene
    assert (ts.gaussians.capacity == n0) is on_fire
    assert ts.gaussians.capacity == js.gaussians.capacity
