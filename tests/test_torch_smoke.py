"""The port's smoke and fire (``render/smoke.py``) against the JAX package,
on the CPU.

Both sides get the same seeded inputs.  Budgets:

- the solver (``step``, ``simulate_smoke`` fixed and adaptive at R = 16
  for 3 frames): every field within 1e-5 of its largest magnitude (the
  two packages' float32 sums and gradients differ in the last bits; the
  vorticity direction is normalized with a 1e-6 floor, so where the
  vorticity's gradient is near zero that rounding can grow: at least
  99.9 % of cells are held to the bound and all to 1e-3), the adaptive
  origins equal;
- ``_shift_zero_fill``, ``sphere_inflow``, ``_lattice_hash``,
  ``value_noise3`` and ``apply_density_noise``: bit-equal, on negative
  lattice coordinates too;
- the densest-cell selection on a field full of ties: the same cells in
  the same order as ``jax.lax.top_k`` (lower index first), which
  ``torch.topk`` does not give;
- ``smoke_fire_gaussians`` and ``smoke_to_gaussians``: every field equal
  but the opacity logit, within 1e-6 of its largest (``log``'s last bit).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.render import smoke as JS
from autovfx_tpu_torch.render import smoke as S

R = 16
FRAMES = 3
FIELD_TOL = 1e-5
ORIGIN = np.array([-0.6, -0.6, -0.3], np.float32)
EXTENT = 1.2


def cfgs(**kw):
    kw = dict(resolution=R, with_fire=True, dissolve_speed=30, **kw)
    return S.SmokeConfig(**kw), JS.SmokeConfig(**kw)


def masks(cfg, jcfg):
    return (S.sphere_inflow(cfg, [8, 8, 3], 2.5, device="cpu"),
            JS.sphere_inflow(jcfg, [8, 8, 3], 2.5))


def assert_fields_close(got, want, tol=FIELD_TOL, share=0.999):
    for name in want._fields:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        bound = tol * max(np.abs(b).max(), 1e-12)
        d = np.abs(a - b)
        assert (d <= bound).mean() >= share, (name, d.max(), bound)
        assert d.max() <= 1e-3 * max(np.abs(b).max(), 1e-12), (name, d.max())


@pytest.fixture(scope="module")
def fixed():
    cfg, jcfg = cfgs()
    m, jm = masks(cfg, jcfg)
    return S.simulate_smoke(cfg, m, FRAMES), JS.simulate_smoke(jcfg, jm, FRAMES)


def test_sphere_inflow_is_jax_s():
    cfg, jcfg = cfgs()
    m, jm = masks(cfg, jcfg)
    assert np.array_equal(m.numpy(), np.asarray(jm))
    assert m.sum() > 0


def test_step_matches_jax():
    """One step from a seeded state with a nonzero velocity field."""
    cfg, jcfg = cfgs()
    rng = np.random.default_rng(0)
    fields = (rng.random((R, R, R), np.float32),
              rng.random((R, R, R), np.float32),
              rng.standard_normal((R, R, R, 3), np.float32) * 0.3)
    m, jm = masks(cfg, jcfg)
    got = S.step(S.SmokeState(*(torch.from_numpy(x) for x in fields)), m, cfg)
    want = JS.step(JS.SmokeState(*(jnp.asarray(x) for x in fields)), jm, jcfg)
    assert_fields_close(got, want)


def test_simulate_fixed_matches_jax(fixed):
    got, want = fixed
    assert_fields_close(got, want)
    assert float(got.density[-1].sum()) > 0


def test_simulate_adaptive_matches_jax():
    """The emitter sits off the cells whose plume centroid lands on a
    rounding tie of the recentering shift (center (R - 1)/2 = 7.5, so an
    emitter at cell 8 gives 0.5, which the order of a float sum decides)."""
    cfg, jcfg = cfgs()
    m = S.sphere_inflow(cfg, [7.3, 8.7, 3.0], 2.5, device="cpu")
    jm = JS.sphere_inflow(jcfg, [7.3, 8.7, 3.0], 2.5)
    assert np.array_equal(m.numpy(), np.asarray(jm))
    on = np.array([True, True, False, True])
    got, origins = S.simulate_smoke(cfg, m, 4, inflow_frames=on,
                                    adaptive=True)
    want, j_origins = JS.simulate_smoke(jcfg, jm, 4,
                                        inflow_frames=jnp.asarray(on),
                                        adaptive=True)
    assert origins.dtype == torch.int32
    assert np.array_equal(origins.numpy(), np.asarray(j_origins))
    assert np.abs(origins.numpy()).max() > 0  # the domain moved
    assert_fields_close(got, want)


@pytest.mark.parametrize("s", [-2, -1, 0, 1, 3])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_shift_zero_fill_matches_jax(s, axis):
    x = np.random.default_rng(1).random((5, 6, 7, 3), np.float32)
    got = S._shift_zero_fill(torch.from_numpy(x), torch.tensor(s), axis)
    want = JS._shift_zero_fill(jnp.asarray(x), jnp.int32(s), axis)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_lattice_hash_bit_equal_on_negative_coordinates():
    rng = np.random.default_rng(2)
    ix, iy, iz = (rng.integers(-5000, 5000, 20000).astype(np.int32)
                  for _ in range(3))
    ix[:4] = [np.iinfo(np.int32).min // 3, -1, 0, 2**20]
    for seed in (0, 17, 18):
        got = S._lattice_hash(*(torch.from_numpy(a) for a in (ix, iy, iz)),
                              seed)
        want = JS._lattice_hash(jnp.asarray(ix), jnp.asarray(iy),
                                jnp.asarray(iz), seed)
        assert np.array_equal(got.numpy(), np.asarray(want)), seed


def test_value_noise3_bit_equal():
    rng = np.random.default_rng(3)
    coords = (rng.random((500, 3), np.float32) * 40.0 - 20.0)
    got = S.value_noise3(torch.from_numpy(coords), 3.52, seed=17)
    want = JS.value_noise3(jnp.asarray(coords), 3.52, seed=17)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("frame", [0, 2, 7])
def test_apply_density_noise_bit_equal(fixed, frame):
    """The noise on JAX's own density field (the lattice drifts below 0
    by frame 2)."""
    cfg, jcfg = cfgs()
    dens = np.array(fixed[1].density[-1])
    got = S.apply_density_noise(torch.from_numpy(dens), frame, cfg)
    want = JS.apply_density_noise(jnp.asarray(dens), frame, jcfg)
    assert np.array_equal(got.numpy(), np.asarray(want))
    got_t = S.apply_density_noise(torch.from_numpy(dens),
                                  torch.tensor(frame), cfg)
    assert torch.equal(got, got_t)


def test_densest_cells_keep_top_k_order_on_ties():
    """A four-way tie in seven scores (torch.topk gives 1, 6, 4 there) and
    a field of 4096 cells in four distinct scores: the selected indices
    are jax.lax.top_k's."""
    small = np.array([0, .9, .9, .5, .9, 0, .9], np.float32)
    _, idx = S._densest(torch.from_numpy(small), 0.0, 3)
    _, j_idx = jax.lax.top_k(jnp.asarray(small), 3)
    assert idx.tolist() == np.asarray(j_idx).tolist() == [1, 2, 4]
    levels = np.array([0.0, 0.01, 0.3, 0.9, 0.9], np.float32)
    field = levels[np.random.default_rng(4).integers(0, 5, (R, R, R))]
    score = np.where(field > 0.02, field, 0.0).reshape(-1)
    for k in (100, 1500, R**3):
        top, idx = S._densest(torch.from_numpy(field), 0.02, k)
        j_top, j_idx = jax.lax.top_k(jnp.asarray(score), k)
        assert np.array_equal(idx.numpy(), np.asarray(j_idx)), k
        assert np.array_equal(top.numpy(), np.asarray(j_top)), k


def assert_sets_equal(got, want):
    for f in ("xyz", "sh_dc", "sh_rest", "log_scales", "quats", "active"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert np.array_equal(a, b), f
    a, b = got.opacity_logit.numpy(), np.asarray(want.opacity_logit)
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("extent", [EXTENT, "tensor"])
def test_smoke_fire_gaussians_match_jax(fixed, extent):
    """On JAX's last frame, with the default (resolution-aware) cap and a
    smaller one; the extent a float or a float32 scalar, as the clip
    passes it."""
    dens = np.array(fixed[1].density[-1])
    temp = np.array(fixed[1].temperature[-1])
    if extent == "tensor":
        p_ext, j_ext = torch.tensor(EXTENT), jnp.float32(EXTENT)
    else:
        p_ext = j_ext = EXTENT
    for cap in (None, 700):
        got = S.smoke_fire_gaussians(torch.from_numpy(dens),
                                     torch.from_numpy(temp), ORIGIN, p_ext,
                                     max_splats=cap)
        want = JS.smoke_fire_gaussians(jnp.asarray(dens), jnp.asarray(temp),
                                       ORIGIN, j_ext, max_splats=cap)
        for g, w in zip(got, want):
            assert_sets_equal(g, w)
        assert bool(got[0].active.any()) and bool(got[1].active.any())


@pytest.mark.parametrize("with_fire", [False, True])
def test_smoke_to_gaussians_matches_jax(fixed, with_fire):
    dens = np.array(fixed[1].density[-1])
    temp = np.array(fixed[1].temperature[-1])
    got = S.smoke_to_gaussians(torch.from_numpy(dens), torch.from_numpy(temp),
                               ORIGIN, EXTENT, max_splats=1000,
                               with_fire=with_fire)
    want = JS.smoke_to_gaussians(jnp.asarray(dens), jnp.asarray(temp),
                                 ORIGIN, EXTENT, max_splats=1000,
                                 with_fire=with_fire)
    assert_sets_equal(got, want)


def test_blackbody_matches_jax():
    t = np.linspace(-0.2, 1.2, 57, dtype=np.float32)
    got = S.blackbody_rgb(torch.from_numpy(t)).numpy()
    want = np.asarray(JS.blackbody_rgb(jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_plume_rises(fixed):
    """The port's own field: the buoyant plume's center of mass climbs
    (the JAX package's tests/test_effects.py rise check, on 3 frames)."""
    got, _ = fixed
    z = torch.arange(R, dtype=torch.float32)
    com = [(d.sum((0, 1)) * z).sum() / d.sum() for d in got.density]
    assert com[-1] > com[0]
