"""SuGaR's density field and regularization in the PyTorch port vs the JAX
package, on the CPU.

The scene is ``tests/test_sugar.py``'s 600-splat sphere shell with
uneven scales, opacities and rotations (``torch_sugar_common``); random
draws are JAX's, fed to the port's explicit-draw arguments.  Budgets:

- values (density, β in three modes, SDF, gradient, samples, losses):
  1e-5 relative to the largest magnitude;
- gradients of the four regularization terms in every parameter field
  (and in the rendered depth and alpha maps) against ``jax.grad``: the
  error over the field's largest magnitude below 5e-4.

The port writes the field's 3×3 algebra as elementwise products; on a
float64 case it is held to the batched matrix products it replaces
(``einsum_field``), values and gradients at 1e-10 of the largest, and a
profiler guard checks that the regularization terms reach no
matrix-multiply op but the camera projection's.
"""
import collections
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from autovfx_tpu.sugar import density as JD
from autovfx_tpu.sugar import regularization as JREG
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.core.quaternion import quat_to_rotmat
from autovfx_tpu_torch.sugar import density as D
from autovfx_tpu_torch.sugar import regularization as REG
from torch_sugar_common import (
    GRAD_TOL,
    close,
    jax_draws,
    jax_gaussians,
    jax_render,
    port_camera,
    port_gaussians,
    ring,
    shell_arrays,
)

N_SAMPLES = 4096
FIELDS = ("xyz", "log_scales", "quats", "opacity_logit")


@pytest.fixture(scope="module")
def shell():
    a = shell_arrays(uneven=True)
    g = jax_gaussians(a)
    cam = ring(1)[0]
    out = jax_render(g, cam)
    nbrs = np.array(JD.reset_neighbors(g))
    rng = np.random.default_rng(0)
    pts = np.asarray(g.xyz)[nbrs[:, 0]] + 0.05 * rng.standard_normal(
        (g.capacity, 3)).astype(np.float32)
    return dict(g=g, cam=cam, depth=out.depth, alpha=out.alpha, nbrs=nbrs,
                pts=pts.astype(np.float32), pg=port_gaussians(a),
                pcam=port_camera(cam))


def test_inverse_covariance_and_neighbours(shell):
    close(D.gaussian_inverse_covariance(shell["pg"]),
          JD.gaussian_inverse_covariance(shell["g"]), what="inverse cov")
    np.testing.assert_array_equal(D.reset_neighbors(shell["pg"]).numpy(),
                                  shell["nbrs"])


def test_density_sdf_and_gradient(shell):
    g, pg = shell["g"], shell["pg"]
    pts, nbrs = shell["pts"], shell["nbrs"]
    tp, tn = torch.as_tensor(pts), torch.as_tensor(nbrs)
    want = JD.compute_density(jnp.asarray(pts), jnp.asarray(nbrs), g)
    got = D.compute_density(tp, tn, pg, chunk=128)  # several chunks
    close(got, want, what="density")
    beta = JD.compute_beta(jnp.asarray(pts), jnp.asarray(nbrs), g)
    close(D.density_to_sdf(got, D.compute_beta(tp, tn, pg)),
          JD.density_to_sdf(want, beta), what="sdf")
    close(D.density_gradient(tp, tn, pg, chunk=100),
          JD.density_gradient(jnp.asarray(pts), jnp.asarray(nbrs), g),
          what="gradient")


@pytest.mark.parametrize("mode", ["average", "weighted_average", "learnable"])
def test_beta_modes(shell, mode):
    pts, nbrs = shell["pts"], shell["nbrs"]
    kw = {"log_beta": -3.0} if mode == "learnable" else {}
    want = JD.compute_beta(jnp.asarray(pts), jnp.asarray(nbrs), shell["g"],
                           mode=mode, **{k: jnp.float32(v) for k, v in kw.items()})
    got = D.compute_beta(torch.as_tensor(pts), torch.as_tensor(nbrs),
                         shell["pg"], mode=mode,
                         **{k: torch.tensor(v) for k, v in kw.items()})
    close(got, want, what=mode)


def test_sampling_with_jax_draws(shell):
    g, pg = shell["g"], shell["pg"]
    key = jax.random.PRNGKey(7)
    mask = jnp.asarray(np.arange(g.capacity) % 3 != 0)
    want, src = JD.sample_points_in_gaussians(g, key, N_SAMPLES, mask=mask)
    draws = jax_draws(g, key, N_SAMPLES, mask=mask)
    got, got_src = D.sample_points_in_gaussians(pg, None, N_SAMPLES,
                                                draws=draws)
    np.testing.assert_array_equal(got_src.numpy(), np.asarray(src))
    close(got, want, what="samples")
    # the port's own draws follow the mask
    idx, eps = D.draw_samples(pg, torch.Generator().manual_seed(0),
                              N_SAMPLES, mask=torch.as_tensor(np.asarray(mask)))
    assert bool((idx % 3 != 0).all()) and eps.shape == (N_SAMPLES, 3)


def _term(REGm, name, samples, g, cam, depth, alpha):
    if name == "entropy":
        return REGm.opacity_entropy_loss(g)
    if name == "normal":
        return REGm.normal_consistency_loss(g, samples)
    fn = (REGm.density_regularization_loss if name == "density"
          else REGm.sdf_regularization_loss)
    return fn(g, samples, cam, depth, alpha)


@pytest.fixture(scope="module")
def jax_terms(shell):
    """Each term's value and its gradients in the fields and the maps,
    with the samples drawn inside the loss (as a coarse step does)."""
    g, cam = shell["g"], shell["cam"]
    key = jax.random.PRNGKey(3)
    out = {}
    for name in ("entropy", "density", "sdf", "normal"):
        def loss(params, depth, alpha, name=name):
            gg = g.replace(**params)
            samples = JREG.sample_sdf_points(gg, key, N_SAMPLES)
            return _term(JREG, name, samples, gg, cam, depth, alpha)

        params = {f: getattr(g, f) for f in FIELDS}
        val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
            params, shell["depth"], shell["alpha"])
        out[name] = (float(val), grads)
    return out, jax_draws(g, key, N_SAMPLES)


@pytest.mark.parametrize("name", ["entropy", "density", "sdf", "normal"])
def test_regularization_terms_and_gradients(shell, jax_terms, name):
    want, draws = jax_terms
    val_want, (g_want, d_want, a_want) = want[name]
    pg = shell["pg"]
    params = {f: getattr(pg, f).clone().requires_grad_(True) for f in FIELDS}
    depth = torch.as_tensor(np.asarray(shell["depth"])).requires_grad_(True)
    alpha = torch.as_tensor(np.asarray(shell["alpha"])).requires_grad_(True)
    gg = dataclasses.replace(pg, **params)
    samples = REG.sample_sdf_points(gg, None, N_SAMPLES, draws=draws)
    val = _term(REG, name, samples, gg, shell["pcam"], depth, alpha)
    close(val, val_want, what=f"{name} value")
    inputs = [*params.values(), depth, alpha]
    grads = torch.autograd.grad(val, inputs, allow_unused=True)
    wants = [g_want[f] for f in FIELDS] + [d_want, a_want]
    for f, got, w in zip(FIELDS + ("depth", "alpha"), grads, wants):
        if got is None:
            assert float(np.abs(np.asarray(w)).max()) == 0.0, f
            continue
        close(got, w, rtol=GRAD_TOL, what=f"{name} d/d{f}")
    if name == "density":  # the maps' cotangents are not zero
        assert float(np.abs(np.asarray(d_want)).max()) > 0
        assert float(np.abs(np.asarray(a_want)).max()) > 0


@pytest.mark.parametrize("mode", ["density", "sdf"])
def test_sugar_losses_evaluate_the_field_once(shell, mode):
    """``coarse_train.sugar_losses``, which hands one evaluation of the
    field to both terms, against the sum of the three terms called apart
    (each evaluating what it reads): the loss and its gradients in the
    fields and the maps within 1e-6 of the largest (the same operations,
    their gradients summed in another order)."""
    from autovfx_tpu_torch.sugar import coarse_train as CT

    pg, cam = shell["pg"], shell["pcam"]
    cfg = CT.SugarConfig(sdf_mode=mode, n_sdf_samples=N_SAMPLES)
    draws = D.draw_samples(pg, torch.Generator().manual_seed(2), N_SAMPLES)
    term = (REG.density_regularization_loss if mode == "density"
            else REG.sdf_regularization_loss)

    def apart(g, depth, alpha):
        samples = REG.sample_sdf_points(g, None, N_SAMPLES, draws=draws)
        return (cfg.entropy_weight * REG.opacity_entropy_loss(g)
                + cfg.sdf_weight * term(g, samples, cam, depth, alpha)
                + cfg.normal_weight * REG.normal_consistency_loss(g, samples))

    def once(g, depth, alpha):
        return CT.sugar_losses(g, cam, depth, alpha, None, cfg, True,
                               draws=draws)

    out = []
    for fn in (once, apart):
        params = {f: getattr(pg, f).clone().requires_grad_(True)
                  for f in FIELDS}
        maps = [torch.as_tensor(np.asarray(shell[k])).requires_grad_(True)
                for k in ("depth", "alpha")]
        val = fn(dataclasses.replace(pg, **params), *maps)
        out.append([val, *torch.autograd.grad(val, [*params.values(),
                                                    *maps])])
    for what, a, b in zip(("loss",) + FIELDS + ("depth", "alpha"), *out):
        scale = float(b.abs().max())
        assert scale > 0, what
        assert float((a - b).abs().max()) <= 1e-6 * scale, what


def test_surface_distance(shell):
    pts = shell["pts"]
    want, wv = JREG.estimate_surface_distance(
        jnp.asarray(pts), shell["cam"], shell["depth"], shell["alpha"])
    got, gv = REG.estimate_surface_distance(
        torch.as_tensor(pts), shell["pcam"],
        torch.as_tensor(np.asarray(shell["depth"])),
        torch.as_tensor(np.asarray(shell["alpha"])))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    m = np.asarray(wv)
    assert m.sum() > 50
    close(got.numpy()[m], np.asarray(want)[m], what="distance")


# ---- the elementwise field against batched matrix products, in float64 -----

EXACT_RTOL = 1e-10
MATMUL_OPS = ("aten::bmm", "aten::einsum", "aten::matmul", "aten::mm",
              "aten::baddbmm")


def einsum_field(points, nbrs, g):
    """Density and its gradient as batched 3×3 products (the field's
    formulation before it was written out elementwise)."""
    rot = quat_to_rotmat(g.rotations)
    inv_s2 = 1.0 / torch.clamp(g.scales**2, min=1e-12)
    inv_cov = torch.einsum("nij,nj,nkj->nik", rot, inv_s2, rot)
    d = points[:, None, :] - g.xyz[nbrs]
    icd = torch.einsum("ckij,ckj->cki", inv_cov[nbrs], d)
    w = g.opacity[nbrs] * torch.exp(-0.5 * torch.einsum("cki,cki->ck", d, icd))
    return inv_cov, w.sum(-1), -torch.sum(w[..., None] * icd, dim=1)


@pytest.fixture(scope="module")
def f64_case():
    """40 Gaussians with uneven scales and random rotations, 64 points
    near them with 8 neighbours each, and sample draws, in float64."""
    rng = np.random.default_rng(5)
    n, p, k = 40, 64, 8
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    g = Gaussians(xyz=t(rng.uniform(-0.3, 0.3, (n, 3))),
                  sh_dc=t(np.zeros((n, 3))), sh_rest=t(np.zeros((n, 0, 3))),
                  log_scales=t(np.log(0.08) + 0.5 * rng.standard_normal((n, 3))),
                  quats=t(rng.standard_normal((n, 4))),
                  opacity_logit=t(rng.standard_normal(n)),
                  active=torch.as_tensor(rng.random(n) > 0.1))
    nbrs = torch.as_tensor(rng.integers(0, n, (p, k)))
    points = g.xyz[nbrs[:, 0]] + t(0.05 * rng.standard_normal((p, 3)))
    draws = (torch.as_tensor(rng.integers(0, n, p)),
             t(rng.standard_normal((p, 3))))
    return g, points, nbrs, draws


def _field_outputs(fn, g, points, nbrs, draws):
    if fn == "inverse_covariance":
        return D.gaussian_inverse_covariance(g)
    if fn == "samples":
        return D.sample_points_in_gaussians(g, None, 0, draws=draws)[0]
    f = D.compute_density if fn == "density" else D.density_gradient
    return f(points, nbrs, g, chunk=24)  # two full chunks and a short one


def _einsum_outputs(fn, g, points, nbrs, draws):
    if fn == "samples":
        idx, eps = draws
        rot = quat_to_rotmat(g.rotations[idx])
        return g.xyz[idx] + torch.einsum("nij,nj->ni", rot, g.scales[idx] * eps)
    inv_cov, dens, grad = einsum_field(points, nbrs, g)
    return {"inverse_covariance": inv_cov, "density": dens,
            "gradient": grad}[fn]


@pytest.mark.parametrize("fn", ["inverse_covariance", "density", "gradient",
                                "samples"])
def test_field_equals_batched_products_in_float64(f64_case, fn):
    """Values, and the gradients of a random projection of them in the
    centres, scales, rotations, opacities and the query points."""
    g0, points0, nbrs, draws = f64_case
    fields = ("xyz", "log_scales", "quats", "opacity_logit")
    got = {}
    for name, run in (("elementwise", _field_outputs),
                      ("einsum", _einsum_outputs)):
        leaves = {f: getattr(g0, f).clone().requires_grad_(True)
                  for f in fields}
        points = points0.clone().requires_grad_(True)
        out = run(fn, dataclasses.replace(g0, **leaves), points, nbrs, draws)
        proj = torch.as_tensor(np.random.default_rng(1).standard_normal(
            tuple(out.shape)))
        inputs = [*leaves.values(), points]
        grads = torch.autograd.grad(torch.sum(out * proj), inputs,
                                    allow_unused=True)
        got[name] = [out] + [torch.zeros_like(x) if gr is None else gr
                             for x, gr in zip(inputs, grads)]
    unused = {"inverse_covariance": ("xyz", "opacity_logit", "points"),
              "samples": ("opacity_logit", "points")}.get(fn, ())
    for what, a, b in zip(("value",) + fields + ("points",), got["elementwise"],
                          got["einsum"]):
        assert a.dtype == torch.float64
        scale = float(b.detach().abs().max())
        if what in unused:
            assert scale == 0.0 and float(a.abs().max()) == 0.0, what
            continue
        assert scale > 0, what
        err = float((a - b).detach().abs().max())
        assert err <= EXACT_RTOL * scale, (fn, what, err / scale)


def _matmul_ops(fn) -> collections.Counter:
    """The matrix-multiply ops the profiler records over ``fn()`` on the
    CPU, by name."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events()
                               if e.name in MATMUL_OPS)


def test_regularization_reaches_no_matmul_but_the_projection(shell):
    """One forward and backward of the density target and the normal
    consistency records no matrix-multiply op besides those of the one
    camera projection in the target's surface distance
    (``Camera.project``), which a projection alone records."""
    pg, cam = shell["pg"], shell["pcam"]
    fields = ("xyz", "log_scales", "quats", "opacity_logit")
    leaves = {f: getattr(pg, f).clone().requires_grad_(True) for f in fields}
    g = dataclasses.replace(pg, **leaves)
    depth = torch.as_tensor(np.asarray(shell["depth"]))
    alpha = torch.as_tensor(np.asarray(shell["alpha"]))
    draws = D.draw_samples(pg, torch.Generator().manual_seed(0), N_SAMPLES)

    def step():
        samples = REG.sample_sdf_points(g, None, N_SAMPLES, draws=draws)
        loss = (REG.density_regularization_loss(g, samples, cam, depth, alpha)
                + REG.normal_consistency_loss(g, samples))
        loss.backward()

    def projection():
        pts = torch.as_tensor(shell["pts"]).requires_grad_(True)
        uv, z = cam.project(pts)
        (uv.sum() + z.sum()).backward()

    got, projected = _matmul_ops(step), _matmul_ops(projection)
    assert leaves["quats"].grad is not None
    assert projected, "the projection records no matrix-multiply op"
    assert got == projected, (got, projected)
