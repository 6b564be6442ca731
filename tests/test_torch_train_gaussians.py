"""The port's COLMAP loader and reconstruction CLI
(``autovfx_tpu_torch.train_gaussians``) vs the JAX package, on the CPU.

Budgets: the COLMAP readers' records equal (``tests/test_dataset.py``'s
model); ``colmap_to_cameras`` at 1e-6; ``load_scene`` against the
repository's ``train_gaussians.load_scene`` (PIL's bicubic resize) with
the images equal to the last bit.  The CLI end to end at 64×48 (4
views, 2,000 SfM points, 4 + 4 iterations, mesh resolution 24, 4,096
SDF samples a step, the prune at opacity 0.05) writes every file, and
every array is finite.
"""
import importlib.util
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_dataset
from autovfx_tpu.dataset import colmap as JCM
from autovfx_tpu_torch import train_gaussians as TG
from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import ply_io
from autovfx_tpu_torch.dataset import colmap as CM
from autovfx_tpu_torch.edit import mesh_io
from autovfx_tpu_torch.ops.rasterize import rasterize
from autovfx_tpu_torch.utils import png
from torch_sugar_common import PCFG, port_gaussians, shell_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_cli():
    """The repository's ``train_gaussians.py`` as a module (it imports
    JAX only inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "reference_train_gaussians", os.path.join(REPO, "train_gaussians.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_colmap_readers_match_jax(tmp_path):
    d = str(tmp_path)
    test_dataset.TestColmapIO._write_model(None, d)
    cams, imgs, (xyz, rgb) = CM.load_colmap_scene(d)
    cams_j, imgs_j, (xyz_j, rgb_j) = JCM.load_colmap_scene(d)
    assert cams.keys() == cams_j.keys() and imgs.keys() == imgs_j.keys()
    for k in cams:
        assert cams[k][:3] == cams_j[k][:3]
        np.testing.assert_array_equal(cams[k].params, cams_j[k].params)
    for k in imgs:
        assert (imgs[k].name, imgs[k].camera_id) == (imgs_j[k].name,
                                                      imgs_j[k].camera_id)
        np.testing.assert_array_equal(imgs[k].qvec, imgs_j[k].qvec)
        np.testing.assert_array_equal(imgs[k].tvec, imgs_j[k].tvec)
    np.testing.assert_array_equal(xyz, xyz_j)
    np.testing.assert_array_equal(rgb, rgb_j)
    q = np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2])
    np.testing.assert_array_equal(CM.qvec_to_rotmat(q), JCM.qvec_to_rotmat(q))
    for ds in (1.0, 2.0):
        pc, names = CM.colmap_to_cameras(d, downscale=ds, device="cpu")
        jc, names_j = JCM.colmap_to_cameras(d, downscale=ds)
        assert names == names_j
        assert (pc.width, pc.height) == (jc.width, jc.height)
        for f in ("R", "t", "fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(getattr(pc, f).numpy(),
                                       np.asarray(getattr(jc, f)), atol=1e-6)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """A COLMAP scene of the 600-splat shell seen by 4 cameras at 128×96:
    its 2,000 SfM points on the shell and its PNGs rendered by the port."""
    root = str(tmp_path_factory.mktemp("scene"))
    a = shell_arrays()
    g = port_gaussians(a)
    cams = [C.look_at_camera([3.0 * np.cos(t), 3.0 * np.sin(t), 0.6],
                             [0, 0, 0], [0, 0, 1], fx=120.0, fy=120.0,
                             width=128, height=96, device="cpu")
            for t in np.linspace(0, 2 * np.pi, 4, endpoint=False)]
    os.makedirs(os.path.join(root, "images"))
    for i, cam in enumerate(cams):
        with torch.no_grad():
            img = rasterize(g, cam, bg=torch.full((3,), 0.2),
                            config=PCFG).color
        png.write_png(os.path.join(root, "images", f"view_{i}.png"),
                      (np.clip(img.numpy(), 0, 1) * 255).astype(np.uint8))
    rng = np.random.default_rng(0)
    d = rng.standard_normal((2000, 3))
    xyz = d / np.linalg.norm(d, axis=1, keepdims=True)
    cs.write_colmap_model(os.path.join(root, "sparse", "0"), cams, xyz,
                          np.round(rng.random((2000, 3)) * 255).astype(
                              np.uint8))
    return root


def test_load_scene_matches_jax(scene_dir):
    args = SimpleNamespace(source_path=scene_dir, downscale=2.0, device="cpu")
    cams, images, xyz, rgb = TG.load_scene(args)
    cams_j, images_j, xyz_j, rgb_j = reference_cli().load_scene(args)
    assert images.shape == (4, 48, 64, 3)
    np.testing.assert_array_equal(images.numpy(), np.asarray(images_j))
    np.testing.assert_array_equal(xyz, xyz_j)
    np.testing.assert_array_equal(rgb, rgb_j)
    for f in ("R", "t", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(cams, f).numpy(),
                                   np.asarray(getattr(cams_j, f)), atol=1e-6)


def test_read_rgb_without_pil_names_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "view.jpg")
    with open(path, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not a png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="view.jpg.*PIL"):
        TG.read_rgb(path)


def test_cli_end_to_end(scene_dir, tmp_path, monkeypatch):
    import functools

    from autovfx_tpu_torch.sugar import coarse_train as CT

    # 4,096 samples a step; and the prune at regularize_from keeps the
    # splats above opacity 0.05, not 0.5: four steps from the initial
    # 0.1 leave none above 0.5
    monkeypatch.setattr(CT, "SugarConfig", functools.partial(
        CT.SugarConfig, n_sdf_samples=4096, prune_opacity_at_reg_start=0.05))
    out = str(tmp_path / "model")
    res = TG.main([
        "--source_path", scene_dir, "--model_path", out, "--downscale", "2",
        "--capacity", "4096", "--iterations", "4", "--coarse_iterations",
        "4", "--regularize_from", "2", "--mesh_resolution", "24",
        "--dup_budget", str(1 << 14), "--device", "cpu"])
    for name in ("chkpnt4.npz", "point_cloud/iteration_4/point_cloud.ply",
                 "sugarcoarse.ply", "mesh.obj", "sugarfine.ply",
                 "texture.png", "metrics.json"):
        assert os.path.exists(os.path.join(out, name)), name
    for state in (res["state"], res["coarse_state"]):
        g = state.gaussians
        for f in ("xyz", "sh_dc", "log_scales", "quats", "opacity_logit"):
            assert bool(torch.isfinite(getattr(g, f)).all()), f
    mesh = mesh_io.load_mesh(os.path.join(out, "mesh.obj"))
    assert len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all()
    fine = ply_io.load_ply(os.path.join(out, "sugarfine.ply"), device="cpu")
    assert fine.capacity == len(res["mesh"].faces)
    assert bool(torch.isfinite(fine.xyz).all())
    tex = png.read_png(os.path.join(out, "texture.png"))
    assert tex.shape == (1024, 1024, 3)
    assert np.isfinite(res["metrics"]["psnr"])
