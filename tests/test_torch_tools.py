"""The port's command-line tools against the JAX package's scripts, on
the CPU.

- ``python -m autovfx_tpu_torch.train_at_scale`` (``scripts/
  train_at_scale.py``): the camera ring and the noisy initialization
  equal to the script's on JAX's scene, the ground-truth renders of
  JAX's scene at the exact path's parity budget (> 70 dB,
  ``tests/test_golden.py``), and a small run whose PSNR rises and whose
  JSON line has the script's keys;
- ``utils/lpips.convert_torch_lpips`` equal to JAX's on seeded state
  dicts, and ``python -m autovfx_tpu_torch.utils.lpips_weights`` writing
  a file that loads as LPIPS's weights.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.core.gaussians import Gaussians as JGaussians
from autovfx_tpu.core.sh import C0
from autovfx_tpu.ops.rasterize import RasterConfig as JConfig
from autovfx_tpu.ops.rasterize import rasterize as j_rasterize
from autovfx_tpu.utils.lpips_jax import convert_torch_lpips as j_convert
from autovfx_tpu.utils.synthetic import make_garden_like
from autovfx_tpu_torch import convert, train_at_scale
from autovfx_tpu_torch.utils import lpips, lpips_weights

SMALL = ["--splats", "2000", "--iters", "50", "--width", "64", "--height",
         "48", "--views", "4"]
# the JSON line of scripts/train_at_scale.py:110-127
SCRIPT_KEYS = {"metric", "value", "unit", "wall_seconds", "final_psnr",
               "active_splats", "history"}
PARITY_DB = 70.0


def jax_ring(views, width, height):
    """scripts/train_at_scale.py:49-60."""
    return JC.stack_cameras([
        JC.look_at_camera(
            [3.2 * np.cos(a), 3.2 * np.sin(a), 1.2 + 0.4 * np.sin(3 * a)],
            [0, 0, 0.2], [0, 0, 1], fx=0.74 * width, fy=0.74 * width,
            width=width, height=height)
        for a in np.linspace(0, 2 * np.pi, views, endpoint=False)])


def jax_initial(gt_model):
    """scripts/train_at_scale.py:78-90."""
    rng = np.random.RandomState(0)
    act = np.asarray(gt_model.active)
    pts = np.asarray(gt_model.xyz)[act]
    pts = pts + 0.02 * rng.randn(*pts.shape).astype(np.float32)
    cols = np.clip(
        (np.asarray(gt_model.sh_dc)[act] * C0 + 0.5)
        + 0.1 * rng.randn(len(pts), 3).astype(np.float32), 0.0, 1.0)
    return JGaussians.create(jnp.asarray(pts), jnp.asarray(cols)).pad_to(
        int(len(pts) * 1.5))


@pytest.fixture(scope="module")
def scene():
    """JAX's scene of the small run, its ring and its renders (the
    script's config on the exact path)."""
    g = make_garden_like(2000, extent=2.67)
    cams = jax_ring(4, 64, 48)
    cfg = JConfig(dup_budget=1 << 15, backend="ref")
    render = jax.jit(lambda c: j_rasterize(g, c, config=cfg).color)
    gt = np.stack([np.asarray(render(JC.index_camera(cams, i)))
                   for i in range(4)])
    pg = convert.gaussians({f: np.asarray(getattr(g, f))
                            for f in convert.GAUSSIAN_FIELDS}, device="cpu")
    return g, cams, gt, pg


def test_ring_and_initialization_match_the_script(scene):
    g, cams, _, pg = scene
    ring = train_at_scale.ring(4, 64, 48, "cpu")
    for f in ("R", "t", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(ring, f).numpy(),
                                   np.asarray(getattr(cams, f)), atol=1e-6,
                                   rtol=0)
    assert (ring.width, ring.height) == (64, 48)
    want = jax_initial(g)
    got = train_at_scale.initial_gaussians(pg)
    assert got.capacity == want.capacity == 3000
    for f in convert.GAUSSIAN_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6,
                                   rtol=0, err_msg=f)


def test_ground_truth_renders_match_jax(scene):
    _, _, gt, pg = scene
    got = train_at_scale.ground_truth(
        pg, train_at_scale.ring(4, 64, 48, "cpu"),
        train_at_scale.raster_config(2000)).numpy()
    for i in range(4):
        mse = float(np.mean((got[i] - gt[i]) ** 2))
        assert -10 * np.log10(max(mse, 1e-20)) > PARITY_DB, i
    assert float(gt.max()) > 0.2  # the views see the scene


@pytest.fixture
def one_thread():
    """The plain path on one thread: beside the suite's other workers,
    torch's intra-op threads oversubscribe the cores (this run takes
    seconds on one thread and minutes contended on all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_small_run_rises_and_prints_the_scripts_line(capsys, one_thread):
    result = train_at_scale.main(SMALL + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(result))
    assert set(result) == SCRIPT_KEYS
    assert result["unit"] == "iters/s" and result["value"] > 0
    assert result["metric"] == ("3DGS from-scratch training 64x48 (2000 GT "
                                "splats, 4 views, 50 iters)")
    assert [h["iter"] for h in result["history"]] == [40, 45, 50]
    # the final PSNR beats the noisy start's, on the same scene and views
    from autovfx_tpu_torch.utils.synthetic import make_garden_like as mgl

    gt_model = mgl(2000, extent=train_at_scale.EXTENT, device="cpu")
    cams = train_at_scale.ring(4, 64, 48, "cpu")
    cfg = train_at_scale.raster_config(2000)
    gt = train_at_scale.ground_truth(gt_model, cams, cfg)
    start = train_at_scale.mean_psnr(
        train_at_scale.initial_gaussians(gt_model), cams, gt, cfg)
    assert result["final_psnr"] > start + 0.5, (start, result)
    assert 0 < result["active_splats"] <= 3000


# ---- LPIPS weights ------------------------------------------------------------


def seeded_states(old_layout=False):
    """torchvision-VGG16-named and lpips-named arrays (one input channel
    a convolution: the converter checks the output channels and kernel
    size, not the input)."""
    rng = np.random.default_rng(0)
    idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    outs = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    vgg = {}
    for i, c in zip(idx, outs):
        vgg[f"features.{i}.weight"] = rng.standard_normal(
            (c, 1, 3, 3)).astype(np.float32)
        vgg[f"features.{i}.bias"] = rng.standard_normal(c).astype(np.float32)
    heads = {}
    for k, c in enumerate((64, 128, 256, 512, 512)):
        key = f"lin{k}.model.1.weight" if old_layout else \
            f"lins.{k}.model.1.weight"
        heads[key] = rng.random((1, c, 1, 1)).astype(np.float32)
    return vgg, heads


@pytest.mark.parametrize("old_layout", [False, True])
def test_convert_torch_lpips_equals_jax(old_layout):
    vgg, heads = seeded_states(old_layout)
    got, want = lpips.convert_torch_lpips(vgg, heads), j_convert(vgg, heads)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bad = dict(vgg, **{"features.0.weight": vgg["features.0.weight"][:32]})
    with pytest.raises(ValueError, match="features.0.weight"):
        lpips.convert_torch_lpips(bad, heads)


def test_lpips_weights_cli_writes_loadable_weights(tmp_path):
    vgg, heads = seeded_states()
    p_vgg, p_lin = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth")
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, p_vgg)
    torch.save({k: torch.from_numpy(v) for k, v in heads.items()}, p_lin)
    out = lpips_weights.main(["--vgg16", p_vgg, "--lpips", p_lin, "--out",
                              str(tmp_path / "w"), "--device", "cpu"])
    assert out == str(tmp_path / "w.npz")
    want = j_convert(vgg, heads)
    with np.load(out) as f:
        assert sorted(f.files) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(f[k], want[k])
    params = lpips.get_params(out, device="cpu")
    assert params.source == "file" and len(params.convs) == 13
    np.testing.assert_array_equal(params.lins[0].numpy(),
                                  heads["lins.0.model.1.weight"].reshape(-1))
