"""The port's LPIPS (``utils/lpips.py``) and evaluation metrics
(``utils/metrics.py``) against the JAX package, on the CPU.

No VGG weights ship with the repository, so the network is held on the
deterministic random-feature parameters and on seeded weight files.
Budgets:

- ``_random_params(seed=0)``: bit-equal to the JAX package's (its HWIO
  filters transposed to OIHW), and ``convert.lpips_params`` carries them
  over bit-equal;
- the committed ``tests/golden/lpips_vector.npz``: rtol 1e-4, the budget
  of ``tests/test_lpips.py``'s test of it; live ``lpips_distance``
  against JAX's, with and without a mask, single and batched: rtol 1e-4;
  its input gradient within 1e-3 of the largest of ``jax.grad``'s;
- ``.npz`` weights (OIHW and HWIO) load to the same parameters as JAX's
  loader and give its distance to rtol 1e-4;
- ``metrics.evaluate`` on a small scene: the frame count and LPIPS
  source equal, PSNR within 1e-3 dB, SSIM within 1e-5, random-feature
  LPIPS to rtol 1e-4; ``lpips`` stays None without a weights file.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.utils import lpips_jax as JL
from autovfx_tpu.utils import metrics as JMET
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.utils import lpips as L
from autovfx_tpu_torch.utils import metrics as MET

RTOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return L._random_params(seed=0, device="cpu"), JL._random_params(seed=0)


def images(seed, h=32, w=40, batch=None):
    shape = (h, w, 3) if batch is None else (batch, h, w, 3)
    return np.random.default_rng(seed).random(shape, np.float32)


def test_random_params_bit_equal(params):
    p, jp = params
    assert p.source == jp.source == "random"
    assert len(p.convs) == len(jp.convs) == 13
    for (w, b), (jw, jb) in zip(p.convs, jp.convs):
        assert np.array_equal(w.numpy(), np.asarray(jw).transpose(3, 2, 0, 1))
        assert np.array_equal(b.numpy(), np.asarray(jb))
    for a, b in zip(p.lins, jp.lins):
        assert np.array_equal(a.numpy(), np.asarray(b))
    carried = convert.lpips_params(jp.convs, jp.lins, jp.source,
                                   device="cpu")
    for (w, b), (cw, cb) in zip(p.convs, carried.convs):
        assert torch.equal(w, cw) and torch.equal(b, cb)


def test_committed_test_vector(params):
    vec = np.load(os.path.join(os.path.dirname(__file__), "golden",
                               "lpips_vector.npz"))
    d = float(L.lpips_distance(torch.from_numpy(vec["img1"]),
                               torch.from_numpy(vec["img2"]),
                               params=params[0]))
    np.testing.assert_allclose(d, float(vec["expected"]), rtol=RTOL)


@pytest.mark.parametrize("case", ["single", "batched", "odd size", "masked"])
def test_lpips_distance_matches_jax(params, case):
    p, jp = params
    kw, jkw = {}, {}
    if case == "batched":
        a, b = images(1, batch=2), images(2, batch=2)
    elif case == "odd size":  # pools floor 17 -> 8 -> 4 -> 2 -> 1
        a, b = images(1, 17, 19), images(2, 17, 19)
    else:
        a, b = images(1), images(2)
    if case == "masked":
        mask = np.zeros((32, 40), np.float32)
        mask[5:20, 8:33] = 1.0
        kw, jkw = {"mask": torch.from_numpy(mask)}, {"mask": jnp.asarray(mask)}
    got = L.lpips_distance(torch.from_numpy(a), torch.from_numpy(b),
                           params=p, **kw).numpy()
    want = np.asarray(JL.lpips_distance(jnp.asarray(a), jnp.asarray(b),
                                        params=jp, **jkw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert (got > 0).all()


def test_lpips_identical_is_zero_and_default_params_are_cpu(params):
    a = torch.from_numpy(images(3))
    assert float(L.lpips_distance(a, a)) < 1e-6  # get_params on a's device
    assert L.get_params(device="cpu").source == "random"


def test_lpips_gradient_matches_jax(params):
    p, jp = params
    a, b = images(4, 16, 16), images(5, 16, 16)
    x = torch.from_numpy(a).requires_grad_(True)
    L.lpips_distance(x, torch.from_numpy(b), params=p).backward()
    want = np.asarray(jax.grad(lambda v: JL.lpips_distance(
        v, jnp.asarray(b), params=jp))(jnp.asarray(a)))
    err = np.abs(x.grad.numpy() - want).max() / np.abs(want).max()
    assert err < 1e-3, err


def fake_weights(hwio: bool):
    rng = np.random.RandomState(0)
    data, cin = {}, 3
    for i, (cout, _) in enumerate(JL._VGG_PLAN):
        w = rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.05
        data[f"conv{i}_w"] = w.transpose(2, 3, 1, 0) if hwio else w
        data[f"conv{i}_b"] = rng.randn(cout).astype(np.float32) * 0.01
        cin = cout
    for k, t in enumerate(JL._TAPS):  # negatives are clipped to 0
        data[f"lin{k}"] = rng.randn(1, JL._VGG_PLAN[t][0], 1, 1).astype(
            np.float32)
    return data


@pytest.mark.parametrize("hwio", [False, True])
def test_weights_file_matches_jax(tmp_path, hwio):
    path = str(tmp_path / "w.npz")
    np.savez(path, **fake_weights(hwio))
    p = L.get_params(path, device="cpu")
    jp = JL._file_params(path)
    assert p.source == jp.source == "file"
    for (w, b), (jw, jb) in zip(p.convs, jp.convs):
        assert np.array_equal(w.numpy(), np.asarray(jw).transpose(3, 2, 0, 1))
        assert np.array_equal(b.numpy(), np.asarray(jb))
    for a, b in zip(p.lins, jp.lins):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert (a >= 0).all()
    a, b = images(6), images(7)
    got = float(L.lpips_distance(torch.from_numpy(a), torch.from_numpy(b),
                                 params=p))
    want = float(JL.lpips_distance(jnp.asarray(a), jnp.asarray(b),
                                   params=jp))
    np.testing.assert_allclose(got, want, rtol=RTOL)


# ---- metrics ------------------------------------------------------------------


def test_eval_split_and_wrapper_match_jax():
    for n in (1, 8, 9, 30):
        assert MET.eval_split(n) == JMET.eval_split(n)
    assert MET.lpips_available() == JMET.lpips_available()
    a, b = images(8), images(9)
    got = MET.lpips(a, b, device="cpu")
    want = JMET.lpips(a, b)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_evaluate_matches_jax(tmp_path):
    """A 300-splat scene seen by 9 cameras (frames 0 and 8 evaluated),
    against noisy renders of itself."""
    from autovfx_tpu.core import cameras as JC
    from autovfx_tpu.ops.rasterize import RasterConfig as JRC
    from autovfx_tpu.utils.synthetic import make_gaussians
    from autovfx_tpu_torch.core.cameras import index_camera
    from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize

    g = make_gaussians(300, jax.random.PRNGKey(3), spread=0.6)
    cams = JC.stack_cameras([
        JC.look_at_camera([2.5 * np.cos(a), 2.5 * np.sin(a), 1.0], [0, 0, 0],
                          [0, 0, 1], fx=40.0, fy=40.0, width=40, height=32)
        for a in np.linspace(0.0, 2.0, 9)])
    jcfg = JRC(dup_budget=1 << 14, backend="ref", tile=16)
    pg = convert.gaussians({f: np.asarray(getattr(g, f))
                            for f in convert.GAUSSIAN_FIELDS}, device="cpu")
    pc = convert.camera({f: np.asarray(getattr(cams, f))
                         if f not in ("width", "height") else getattr(cams, f)
                         for f in convert.CAMERA_FIELDS}, device="cpu")
    cfg = RasterConfig(dup_budget=1 << 14, tile=16)
    rng = np.random.default_rng(10)
    gt = np.stack([np.clip(
        rasterize(pg, index_camera(pc, i), config=cfg).color.numpy()
        + rng.normal(0, 0.05, (32, 40, 3)), 0, 1).astype(np.float32)
        for i in range(9)])
    want = JMET.evaluate(g, cams, gt, config=jcfg)
    out = str(tmp_path / "metrics.json")
    got = MET.evaluate(pg, pc, gt, config=cfg, out_json=out)
    assert os.path.exists(out)
    for k in ("num_eval_frames", "lpips", "lpips_source"):
        assert got[k] == want[k], k
    assert got["num_eval_frames"] == 2 and got["lpips"] is None
    assert abs(got["psnr"] - want["psnr"]) < 1e-3
    np.testing.assert_allclose(got["per_frame_psnr"], want["per_frame_psnr"],
                               atol=1e-3)
    assert abs(got["ssim"] - want["ssim"]) < 1e-5
    np.testing.assert_allclose(got["lpips_random_features"],
                               want["lpips_random_features"], rtol=RTOL)
