"""The port's DiffusionLight post-processing (``render/difflight.py``) and
panorama (``render/panorama.py``) against the JAX package, on the CPU.

``tests/test_difflight.py``'s cases run through both packages on its
synthetic oracles: the numpy stages (unwrap, exposure merge, the whole
chain, the crop loader) are equal to the JAX package's to float32
rounding (1e-6 of the largest value), and the camera-to-world rotation
(``envmap.rotate_envmap_cam_to_world`` on the CPU) within 1e-5 of it.
The oracles' own bounds hold on the port's results.  ``render_panorama``
at face size 32 against JAX's (``backend="ref"``): the six faces'
cameras equal, the panorama > 70 dB (the exact path's budget,
``tests/test_golden.py``).
"""
import os
import sys

import numpy as np
import jax
import pytest

from autovfx_tpu.render import difflight as JDL
from autovfx_tpu_torch.render import difflight as DL

sys.path.insert(0, os.path.dirname(__file__))

from test_difflight import recoverable_mask, smooth_env  # noqa: E402

EVS = [0.0, -2.5, -5.0]


def ldr(hdr, ev, gamma=2.4):
    return np.clip(hdr * (2.0 ** ev), 0, 1) ** (1.0 / gamma)


def assert_close(a, b, tol=1e-6):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-12)


@pytest.fixture(scope="module")
def hdr_crops():
    hdr = smooth_env(h=64, peak=16.0)
    ball = DL.render_mirror_ball(hdr, ball_size=512)
    assert np.array_equal(ball, JDL.render_mirror_ball(hdr, ball_size=512))
    return hdr, {ev: np.clip(ball * (2.0 ** ev), 0, 1) ** (1.0 / 2.4)
                 for ev in EVS}


def test_mirror_ball_roundtrip():
    env = smooth_env(h=64, peak=0.0)
    ball = DL.render_mirror_ball(env, ball_size=512)
    rec = DL.unwrap_ball_to_envmap(ball, env_height=64, scale=4)
    assert_close(rec, JDL.unwrap_ball_to_envmap(ball, env_height=64, scale=4))
    err = np.abs(rec - env)[recoverable_mask(64)]
    assert err.mean() < 0.01
    assert err.max() < 0.08


def test_forward_facing_texel_exact():
    env = smooth_env(h=32, peak=0.0)
    ball = DL.render_mirror_ball(env, ball_size=257)
    rec = DL.unwrap_ball_to_envmap(ball, env_height=32, scale=2)
    assert_close(rec, JDL.unwrap_ball_to_envmap(ball, env_height=32,
                                                scale=2))
    np.testing.assert_allclose(rec[16, 0], ball[128, 128], atol=0.02)


def test_exposure_merge_recovers_hdr():
    hdr = smooth_env(h=48, peak=16.0)
    imgs = [ldr(hdr, ev) for ev in EVS]
    merged = DL.merge_exposure_brackets(imgs, EVS)
    assert_close(merged, JDL.merge_exposure_brackets(imgs, EVS))
    lum_gt = hdr @ np.array([0.212671, 0.715160, 0.072169])
    rec = lum_gt < 0.85 * 2.0 ** 5.0
    for ev in EVS:
        maxval = 2.0 ** (-ev)
        rec &= ~((lum_gt > 0.8 * maxval) & (lum_gt < 1.2 * maxval))
    rel = np.abs(merged - hdr)[rec] / np.maximum(hdr[rec], 1e-3)
    assert rel.mean() < 0.02
    assert np.quantile(rel, 0.99) < 0.1
    assert merged.max() > 4.0


def test_ball_crops_to_envmap(hdr_crops):
    hdr, crops = hdr_crops
    rec = DL.envmap_from_ball_crops(crops, env_height=64, device="cpu")
    assert_close(rec, JDL.envmap_from_ball_crops(crops, env_height=64))
    m = recoverable_mask(64)
    lum = hdr @ np.array([0.212671, 0.715160, 0.072169])
    m &= lum < 0.85 * 2.0 ** 5.0
    rel = np.abs(rec - hdr)[m] / np.maximum(hdr[m], 1e-2)
    assert np.median(rel) < 0.05
    assert rec.max() > 4.0


def test_load_ball_crops_needs_no_pil_for_npy(tmp_path, monkeypatch):
    hdr = smooth_env(h=32, peak=2.0)
    for ev, tag in [(0.0, "0"), (-2.5, "-25"), (-5.0, "-50")]:
        np.save(tmp_path / f"ball_ev{tag}.npy",
                ldr(DL.render_mirror_ball(hdr, 64), ev))
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL fails
    crops = DL.load_ball_crops(str(tmp_path))
    want = JDL.load_ball_crops(str(tmp_path))
    assert sorted(crops) == sorted(want) == [-5.0, -2.5, 0.0]
    for ev in crops:
        assert np.array_equal(crops[ev], want[ev])
    out = DL.envmap_from_ball_crops(crops, env_height=32, device="cpu")
    assert out.shape == (32, 64, 3)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        DL.load_ball_crops(str(tmp_path / "empty"))


@pytest.mark.parametrize("angle", [0.0, 0.7])
def test_rotation_hook_matches_jax(angle):
    hdr = smooth_env(h=32, peak=2.0)
    crops = {0.0: DL.render_mirror_ball(hdr, 128) ** (1 / 2.4)}
    c, s = np.cos(angle), np.sin(angle)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    out = DL.envmap_from_ball_crops(crops, c2w=c2w, env_height=32,
                                    device="cpu")
    want = JDL.envmap_from_ball_crops(crops, c2w=c2w, env_height=32)
    assert out.shape == (32, 64, 3) and np.isfinite(out).all()
    assert_close(out, want, tol=1e-5)


def test_panorama_matches_jax():
    from autovfx_tpu.core import cameras as JC
    from autovfx_tpu.ops.rasterize import RasterConfig as JRC
    from autovfx_tpu.render.panorama import _FACES
    from autovfx_tpu.render.panorama import render_panorama as j_pano
    from autovfx_tpu.utils.synthetic import make_gaussians
    from autovfx_tpu_torch import convert
    from autovfx_tpu_torch.ops.rasterize import RasterConfig
    from autovfx_tpu_torch.render import panorama as PANO

    g = make_gaussians(400, jax.random.PRNGKey(0), spread=2.0,
                       scale_range=(0.1, 0.3))
    center = np.array([0.1, -0.2, 0.05])
    assert PANO.FACES == _FACES
    for cam, (fwd, up) in zip(PANO.face_cameras(center, 32, "cpu"), _FACES):
        want_cam = JC.look_at_camera(center, center + np.asarray(fwd), up,
                                     fx=16.0, fy=16.0, width=32, height=32)
        assert np.array_equal(cam.R.numpy(), np.asarray(want_cam.R))
        assert np.array_equal(cam.t.numpy(), np.asarray(want_cam.t))
    want = j_pano(g, center, face_size=32, out_height=32,
                  config=JRC(dup_budget=1 << 14, backend="ref"))
    pg = convert.gaussians({f: np.asarray(getattr(g, f))
                            for f in convert.GAUSSIAN_FIELDS}, device="cpu")
    got = PANO.render_panorama(pg, center, face_size=32, out_height=32,
                               config=RasterConfig(dup_budget=1 << 14))
    assert got.shape == want.shape == (32, 64, 3)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    mse = np.mean((got.astype(np.float64) - want) ** 2)
    assert -10 * np.log10(max(mse, 1e-30)) > 70.0
    assert (got > 0.05).mean() > 0.3  # most directions see splats
