"""The port's liquid melt (``render/liquid.py``) and melt/incinerate
effects (``render/melt.py``) against the JAX package, on the CPU.

Both sides get the same seeded inputs.  Budgets:

- ``MeltSim.run`` at R = 32 with 4 substeps over 10 frames (6 of melting,
  4 of flow): h, eta and the volume within 1e-6 of their largest
  magnitude, the tracer positions within 1e-4 of theirs and the normals
  within 1e-4 (they are gradients of the surface, which amplify its
  last-bit differences), the melted flags equal;
- ``frame_mesh`` (host numpy on the port's surface): the faces equal and
  the vertices within 1e-6 m;
- ``bed_from_mesh``: within 4 float32 ulps of the rays' 1e3 start height
  of JAX's height map;
- ``apply_melt_to_gaussians``, ``melt_gaussians`` and
  ``incinerate_gaussians``: every field within 1e-6 of its largest;
  ``melt_surfels``, ``incinerate_colors`` and ``effect_progress`` equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.render import liquid as JL
from autovfx_tpu.render import melt as JM
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.render import liquid as L
from autovfx_tpu_torch.render import melt as M

PROGRESS = np.concatenate([np.linspace(0.0, 1.0, 6), np.ones(4)]
                          ).astype(np.float32)


def cube_points(n=400, edge=0.5, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 3).astype(np.float32) * edge
    pts[:, :2] -= edge / 2
    nrm = rng.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


@pytest.fixture(scope="module")
def sims():
    pts, nrm = cube_points()
    kw = dict(resolution=32, substeps=4, viscosity=5e-4)
    r = kw["resolution"]
    bed = np.tile(np.linspace(0.05, 0.0, r, dtype=np.float32)[:, None],
                  (1, r))
    sim = L.MeltSim(pts, nrm, bed=bed, cfg=L.LiquidConfig(**kw),
                    device="cpu")
    j_sim = JL.MeltSim(pts, nrm, bed=bed, cfg=JL.LiquidConfig(**kw))
    return sim, sim.run(PROGRESS), j_sim, j_sim.run(PROGRESS)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def test_melt_sim_setup_matches_jax(sims):
    sim, _, j_sim, _ = sims
    for name in ("extent", "cell", "ground_z", "height", "volume"):
        assert getattr(sim, name) == getattr(j_sim, name), name
    assert np.array_equal(sim.origin, j_sim.origin)
    assert np.array_equal(sim.footprint.numpy(), np.asarray(j_sim.footprint))


def test_melt_sim_run_matches_jax(sims):
    _, got, _, want = sims
    for name in ("h", "eta", "volume"):
        assert rel_err(getattr(got, name).numpy(), getattr(want, name)) \
            <= 1e-6, name
    assert rel_err(got.tracer_pos.numpy(), want.tracer_pos) <= 1e-4
    assert np.abs(got.tracer_norm.numpy()
                  - np.asarray(want.tracer_norm)).max() <= 1e-4
    assert np.array_equal(got.tracer_fluid.numpy(),
                          np.asarray(want.tracer_fluid))
    # the solve did something: fluid, melted tracers, volume conserved
    assert got.tracer_fluid[-1].mean() == 1.0
    assert float(got.volume[-1]) == pytest.approx(sims[0].volume, rel=1e-4)


@pytest.mark.parametrize("frame", [0, 5, 9])
def test_frame_mesh_matches_jax(sims, frame):
    sim, got, j_sim, want = sims
    v, f = sim.frame_mesh(got, frame)
    jv, jf = j_sim.frame_mesh(want, frame)
    assert np.array_equal(f, jf)
    assert v.shape == jv.shape
    if len(v):
        assert np.abs(v - jv).max() <= 1e-6


def test_substep_matches_jax():
    rng = np.random.default_rng(1)
    h = (rng.random((24, 24), np.float32) * 0.02)
    bed = rng.random((24, 24), np.float32) * 0.01
    src = rng.random((24, 24), np.float32) * 1e-4
    cfg = dict(resolution=24, substeps=4, viscosity=5e-4)
    got = L._substep(*(torch.from_numpy(x) for x in (h, bed, src)), 0.02,
                     L.LiquidConfig(**cfg))
    want = JL._substep(*(jnp.asarray(x) for x in (h, bed, src)), 0.02,
                       JL.LiquidConfig(**cfg))
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), b) <= 1e-6


def test_bed_from_mesh_matches_jax():
    # a tilted quad whose diagonal passes through no cell center (a ray
    # along a shared edge hits or misses by rounding)
    v = np.array([[0.3, 0.31, 0.5], [0.7, 0.3, 0.5], [0.71, 0.7, 0.6],
                  [0.3, 0.7, 0.5]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    kw = dict(origin=np.array([0.0, 0.0]), extent=1.0, resolution=32,
              ground_z=0.1)
    got = L.bed_from_mesh(v, f, device="cpu", **kw)
    want = JL.bed_from_mesh(v, f, **kw)
    assert got.shape == (32, 32) and got.dtype == np.float32
    # heights are z_top (1e3) minus a hit distance: 4 float32 ulps there
    assert np.abs(got - want).max() <= 4 * np.spacing(np.float32(1e3))
    assert got[16, 16] == pytest.approx(0.45, abs=1e-2)
    assert got[2, 2] == 0.0


def splat_object(n=300, seed=5):
    """A seeded splat object above z = 0.7, as numpy fields."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return dict(
        xyz=(rng.standard_normal((n, 3)) * 0.3 + [0, 0, 1.0]
             ).astype(np.float32),
        sh_dc=rng.standard_normal((n, 3)).astype(np.float32),
        sh_rest=(0.05 * rng.standard_normal((n, 15, 3))).astype(np.float32),
        log_scales=np.log(rng.uniform(0.01, 0.08, (n, 3))).astype(np.float32),
        quats=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacity_logit=rng.standard_normal(n).astype(np.float32),
        active=np.ones(n, bool))


def both(fields):
    from autovfx_tpu.core.gaussians import Gaussians as JG

    return (convert.gaussians(fields, device="cpu"),
            JG(**{k: jnp.asarray(v) for k, v in fields.items()}))


def assert_gaussians_close(got, want, tol=1e-6):
    for f in convert.GAUSSIAN_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "active":
            assert np.array_equal(a, b)
        else:
            assert rel_err(a, b) <= tol, f


@pytest.mark.parametrize("frame", [2, 9])
def test_apply_melt_to_gaussians_matches_jax(sims, frame):
    sim, got, _, want = sims
    fields = splat_object(n=500)
    g, jg = both(fields)
    idx = np.random.default_rng(6).permutation(500)[:400]
    a = L.apply_melt_to_gaussians(g, idx, got, frame, sim.cell)
    b = JL.apply_melt_to_gaussians(jg, idx, want, frame, sim.cell)
    # the positions carry the run's own differences (1e-4, above)
    assert rel_err(a.xyz.numpy(), b.xyz) <= 1e-4
    for f in ("log_scales", "quats"):
        assert rel_err(getattr(a, f).numpy(), getattr(b, f)) <= 1e-6, f
    assert torch.equal(a.sh_dc, g.sh_dc)


@pytest.mark.parametrize("progress", [0.0, 0.4, 1.0])
def test_melt_gaussians_matches_jax(progress):
    g, jg = both(splat_object())
    assert_gaussians_close(M.melt_gaussians(g, progress),
                           JM.melt_gaussians(jg, progress))
    assert_gaussians_close(M.melt_gaussians(g, progress, ground_z=0.5),
                           JM.melt_gaussians(jg, progress, ground_z=0.5))


@pytest.mark.parametrize("progress", [0.0, 0.5, 0.85, 1.0])
def test_incinerate_gaussians_matches_jax(progress):
    g, jg = both(splat_object())
    assert_gaussians_close(M.incinerate_gaussians(g, progress),
                           JM.incinerate_gaussians(jg, progress))


@pytest.mark.parametrize("progress", [0.0, 0.3, 1.0])
def test_surfel_effects_equal_jax(progress):
    pts, nrm = cube_points(200, seed=2)
    for a, b in zip(M.melt_surfels(pts, nrm, progress),
                    JM.melt_surfels(pts, nrm, progress)):
        assert np.array_equal(a, b)
    cols = np.random.default_rng(3).random((50, 3), np.float32)
    for a, b in zip(M.incinerate_colors(cols, progress),
                    JM.incinerate_colors(cols, progress)):
        assert np.array_equal(a, b)


def test_effect_progress_equals_jax():
    for args in [(0, 1, None, 10), (3, 5, 11, 10), (7, 5, 11, 10),
                 (20, 2, 6, 30), (4, 5, None, 5)]:
        assert M.effect_progress(*args) == JM.effect_progress(*args), args
