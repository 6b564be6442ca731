"""Preprocess of the PyTorch port vs the JAX package, on the CPU.

The port's plain ``projection.preprocess`` (what kernel 1 is held
against on the card) is compared with JAX ``projection.preprocess`` and
with the fused Pallas ``preprocess_packed`` run in interpret mode, on
the golden 20k-splat scene at tile 16 and tile 32.  Tolerances:

- ``mean2d`` abs 1e-4 px, on the splats that touch a tile (off-screen
  splats sit ~10^3 px out, where one float32 ulp is ~1e-4);
- ``conic``, ``color``, ``depth`` rel 1e-5 (abs 1e-6);
- ``opacity`` abs 1e-6;
- ``radius``, ``tile_min``, ``tile_max``, ``tiles_touched`` exactly equal
  on >= 99.9 % of splats and off by at most 1 elsewhere;
- the fused kernel's bf16-paired feature rows 6-7 at rel 2^-8.
"""
import numpy as np
import jax.numpy as jnp
import jax.experimental.pallas as pl
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.ops import preprocess_pallas as PP
from autovfx_tpu.ops import projection as JPr
from autovfx_tpu.utils.synthetic import make_garden_like
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.ops import preprocess_cuda, projection
from autovfx_tpu_torch.utils import trace

INT_FIELDS = ("radius", "tile_min", "tile_max", "tiles_touched")


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(PP.pl, "pallas_call", patched)


@pytest.fixture(scope="module")
def scene():
    g = make_garden_like(20_000, extent=2.67)
    cam = JC.look_at_camera(
        [2.6, 0.0, 1.4], [0, 0, 0.2], [0, 0, 1],
        fx=96.0, fy=96.0, width=128, height=96,
    )
    gt = convert.gaussians(
        {f: np.asarray(getattr(g, f)) for f in convert.GAUSSIAN_FIELDS},
        device="cpu",
    )
    ct = convert.camera(
        {f: np.asarray(getattr(cam, f)) if f not in ("width", "height")
         else getattr(cam, f) for f in convert.CAMERA_FIELDS},
        device="cpu",
    )
    return g, cam, gt, ct


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_ints(port, ref):
    d = np.abs(np_(port).astype(np.int64) - np_(ref).astype(np.int64))
    d = d.reshape(d.shape[0], -1).max(axis=1)
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()


def check_floats(port, ref, live):
    np.testing.assert_allclose(np_(port.mean2d)[live], np_(ref.mean2d)[live],
                               rtol=0, atol=1e-4)
    for f in ("conic", "color", "depth"):
        np.testing.assert_allclose(np_(getattr(port, f)),
                                   np_(getattr(ref, f)), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(np_(port.opacity), np_(ref.opacity), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("tile", [16, 32])
def test_plain_matches_jax_projection(scene, tile):
    g, cam, gt, ct = scene
    ref = JPr.preprocess(g, cam, tile=tile)
    port = projection.preprocess(gt, ct, tile=tile)
    live = np_(ref.tiles_touched) > 0
    assert live.sum() > 5000
    check_floats(port, ref, live)
    for f in INT_FIELDS:
        check_ints(getattr(port, f), getattr(ref, f))


@pytest.mark.parametrize(
    "kw", [dict(sh_degree=1), dict(scaling_modifier=0.6), dict(sh_degree=0)]
)
def test_plain_options_match_jax(scene, kw):
    g, cam, gt, ct = scene
    ref = JPr.preprocess(g, cam, tile=16, **kw)
    port = projection.preprocess(gt, ct, tile=16, **kw)
    check_floats(port, ref, np_(ref.tiles_touched) > 0)
    for f in INT_FIELDS:
        check_ints(getattr(port, f), getattr(ref, f))


def test_override_color_and_inactive(scene):
    g, cam, gt, ct = scene
    n = g.capacity
    rgb = np.random.default_rng(0).random((n, 3), dtype=np.float32)
    active = np.arange(n) % 4 != 0
    gj = g.replace(active=jnp.asarray(active))
    gp = convert.gaussians(
        {f: np.asarray(getattr(gj, f)) for f in convert.GAUSSIAN_FIELDS},
        device="cpu",
    )
    ref = JPr.preprocess(gj, cam, override_color=jnp.asarray(rgb))
    port = projection.preprocess(gp, ct, override_color=torch.from_numpy(rgb))
    check_floats(port, ref, np_(ref.tiles_touched) > 0)
    assert np_(port.tiles_touched)[~active].max() == 0


@pytest.mark.parametrize("tile", [16, 32])
def test_plain_matches_fused_pallas(scene, tile):
    g, cam, gt, ct = scene
    n = g.capacity
    ps = PP.preprocess_packed(PP.pack_scene_rows(g), n, cam, tile=tile)
    port = projection.preprocess(gt, ct, tile=tile)
    s = ps.splats
    for f in INT_FIELDS:
        check_ints(getattr(port, f), np_(getattr(s, f))[:n])
    live = (np_(port.tiles_touched) > 0) & (np_(s.tiles_touched)[:n] > 0)
    np.testing.assert_allclose(np_(port.depth)[live], np_(s.depth)[:n][live],
                               rtol=1e-5, atol=1e-6)

    feat = np.asarray(ps.feat)[:, :n]
    np.testing.assert_allclose(np_(port.mean2d)[live], feat[0:2].T[live],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np_(port.conic)[live], feat[2:5].T[live],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.log(np_(port.opacity)[live]), feat[5][live],
                               rtol=1e-5, atol=1e-6)

    # rows 6-7: (r | g), (b | depth) as bf16 pairs
    bits = np.ascontiguousarray(feat[6:8]).view(np.uint32)
    hi = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    lo = (bits << np.uint32(16)).view(np.float32)
    col, dep = np_(port.color), np_(port.depth)
    for got, want in [(hi[0], col[:, 0]), (lo[0], col[:, 1]),
                      (hi[1], col[:, 2]), (lo[1], dep)]:
        np.testing.assert_allclose(got[live], want[live], rtol=2.0**-8,
                                   atol=1e-30)


def test_wrapper_takes_plain_path_for_cpu_tensors(scene, monkeypatch):
    """A CPU tensor never reaches the library loader, and gets exactly the
    plain version's result."""
    _, _, gt, ct = scene

    def refuse():
        raise AssertionError("CPU tensors must not load the CUDA library")

    monkeypatch.setattr(preprocess_cuda._build, "load_library", refuse)
    before = trace.counters().get("launch.preprocess", 0)
    a = preprocess_cuda.preprocess(gt, ct, tile=32)
    b = projection.preprocess(gt, ct, tile=32)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert trace.counters().get("launch.preprocess", 0) == before
