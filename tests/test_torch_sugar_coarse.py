"""Coarse SuGaR training in the PyTorch port vs the JAX package, on the CPU.

The 600-splat sphere shell (uneven scales and rotations: at isotropic
scales a rotation's gradient is rounding noise, which Adam's first
normalized step turns into a full step of either sign; uneven
opacities, so the prune at ``regularize_from`` removes some) is fitted
to renders of a recoloured copy through 4 cameras at 64×48.  The
isotropic case, where the min-axis normals tie and both packages take
the first axis, is held here in the normal term alone.  JAX's camera and sample
draws are fed to the port.  Budgets:

- ``sugar_losses`` plain and regularized: 1e-5 relative;
- ``coarse_train`` over 3 steps crossing ``regularize_from`` (one plain
  step, the prune, two regularized steps): each step's loss and PSNR at
  1e-5 relative, the active mask exactly, and every parameter field, both
  Adam moments and the densify statistics within 5e-4 of the field's
  largest magnitude;
- one regularized step's loss (1e-5) and its gradients in every field
  and in the screen-position offset against ``jax.grad`` (5e-4).

Opacities stay below 0.99, where the reference's clamp gradient and the
port's straight-through one agree (``tests/test_torch_train.py``).
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.sugar import coarse_train as JCT
from autovfx_tpu.train import trainer as JT
from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.sugar import coarse_train as CT
from autovfx_tpu_torch.train import trainer as T
from torch_sugar_common import (
    GRAD_TOL,
    JCFG,
    PCFG,
    close,
    jax_draws,
    jax_gaussians,
    jax_render,
    port_camera,
    port_gaussians,
    ring,
    shell_arrays,
)

N_SAMPLES = 2048
ITERATIONS, REGULARIZE_FROM = 3, 2
FIELDS = ("xyz", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logit")


def scene_arrays() -> dict:
    a = shell_arrays(uneven=True)
    a["opacity_logit"] = np.clip(np.random.default_rng(1).normal(
        0.5, 1.5, len(a["xyz"])), -4.0, 4.0).astype(np.float32)
    return a


def configs():
    jcfg = JCT.SugarConfig(
        base=JT.TrainConfig(iterations=ITERATIONS, raster=JCFG,
                            densify_from_iter=10**9, spatial_lr_scale=2.0),
        regularize_from=REGULARIZE_FROM, n_sdf_samples=N_SAMPLES)
    pcfg = CT.SugarConfig(
        base=T.TrainConfig(iterations=ITERATIONS, raster=PCFG,
                           densify_from_iter=10**9, spatial_lr_scale=2.0),
        regularize_from=REGULARIZE_FROM, n_sdf_samples=N_SAMPLES)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def run():
    a = scene_arrays()
    g = jax_gaussians(a)
    cams = ring(4)
    target = jax_gaussians(dict(a, sh_dc=a["sh_dc"][::-1].copy()))
    images = np.stack([np.asarray(jax_render(target, c).color) for c in cams])
    jcfg, pcfg = configs()
    jstack = JC.stack_cameras(cams)
    state, hist = JCT.coarse_train(g, jstack, images, jcfg, log_every=1)

    # JAX's draws: the camera of each step and the samples of each
    # regularized one (drawn over the active mask of that step)
    key = jax.random.PRNGKey(0)
    cam_idx, draws = [], []
    for it in range(1, ITERATIONS + 1):
        key, k1, k2 = jax.random.split(key, 3)
        cam_idx.append(int(jax.random.randint(k1, (), 0, len(cams))))
        if it >= REGULARIZE_FROM:
            g_it = g if it == REGULARIZE_FROM else state.gaussians
            draws.append(jax_draws(g_it, k2, N_SAMPLES))
    return dict(a=a, g=g, cams=cams, images=images, state=state, hist=hist,
                cam_idx=cam_idx, draws=draws, pcfg=pcfg, jcfg=jcfg)


def test_sugar_losses(run):
    g, cam = run["g"], run["cams"][1]
    out = jax_render(g, cam)
    key = jax.random.PRNGKey(5)
    pg, pcam = port_gaussians(run["a"]), port_camera(cam)
    depth = torch.as_tensor(np.asarray(out.depth))
    alpha = torch.as_tensor(np.asarray(out.alpha))
    for regularize in (False, True):
        want = jax.jit(lambda g, d, a, k: JCT.sugar_losses(
            g, cam, d, a, k, run["jcfg"], regularize))(g, out.depth,
                                                        out.alpha, key)
        got = CT.sugar_losses(pg, pcam, depth, alpha, None, run["pcfg"],
                              regularize, draws=jax_draws(g, key, N_SAMPLES))
        close(got, float(want), what=f"sugar_losses regularize={regularize}")


def test_coarse_train_matches_jax(run):
    state_j = run["state"]
    pcams = C.stack_cameras([port_camera(c) for c in run["cams"]])
    state, hist = CT.coarse_train(
        port_gaussians(run["a"]), pcams, torch.as_tensor(run["images"]),
        run["pcfg"], log_every=1, cam_indices=run["cam_idx"],
        sdf_draws=run["draws"])
    assert state.step == ITERATIONS == int(state_j.step)
    for h, hj in zip(hist, run["hist"]):
        close(h["loss"], hj["loss"], what=f"loss at step {h['iter']}")
        close(h["psnr"], hj["psnr"], what=f"psnr at step {h['iter']}")
    active = state.gaussians.active.numpy()
    np.testing.assert_array_equal(active, np.asarray(state_j.gaussians.active))
    assert 0 < int((~active).sum()) < len(active)  # the prune removed some
    for f in FIELDS:
        close(getattr(state.gaussians, f), getattr(state_j.gaussians, f),
              rtol=GRAD_TOL, what=f"gaussians.{f}")
        for mom in ("m", "v"):
            close(getattr(getattr(state.adam, mom), f),
                  getattr(getattr(state_j.adam, mom), f), rtol=GRAD_TOL,
                  what=f"adam.{mom}.{f}")
    close(state.stats.grad_accum, state_j.stats.grad_accum, rtol=GRAD_TOL,
          what="densify grad_accum")
    np.testing.assert_array_equal(state.stats.denom.numpy(),
                                  np.asarray(state_j.stats.denom))


def test_coarse_loss_gradients_match_jax(run):
    from autovfx_tpu.ops.rasterize import rasterize as j_rasterize

    g, cam, a = run["g"], run["cams"][1], run["a"]
    img = run["images"][1]
    jcfg, pcfg = run["jcfg"], run["pcfg"]
    key = jax.random.PRNGKey(11)

    def loss_fn(params, offset):  # JAX's coarse step, coarse_train.py:99-108
        gg = g.replace(**params)
        loss, _ = JT.compute_loss(gg, offset, cam, img, jcfg.base)
        out = j_rasterize(gg, cam, config=jcfg.base.raster)
        return loss + JCT.sugar_losses(gg, cam, out.depth, out.alpha, key,
                                       jcfg, True)

    val, (g_want, off_want) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1)))({f: getattr(g, f) for f in FIELDS},
                                  jax.numpy.zeros((g.capacity, 2)))
    pg = port_gaussians(a)
    params = {f: getattr(pg, f).clone().requires_grad_(True) for f in FIELDS}
    offset = torch.zeros((pg.capacity, 2), requires_grad=True)
    loss, _ = CT.coarse_loss(dataclasses.replace(pg, **params), offset,
                             port_camera(cam), torch.as_tensor(img), pcfg,
                             True, None, jax_draws(g, key, N_SAMPLES))
    close(loss, float(val), what="coarse loss")
    grads = torch.autograd.grad(loss, [*params.values(), offset])
    for f, got in zip(FIELDS, grads):
        close(got, g_want[f], rtol=GRAD_TOL, what=f"d/d{f}")
    close(grads[-1], off_want, rtol=GRAD_TOL, what="d/d mean2d_offset")


def test_a_plain_step_skips_the_second_render(run, monkeypatch):
    """A plain step renders once and a regularized one twice, each with
    its backward (kernels 1-4 once and twice on the card)."""
    calls = []
    real = CT.rasterize
    monkeypatch.setattr(CT, "rasterize",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    state = T.init_state(port_gaussians(run["a"]))
    cam = port_camera(run["cams"][0])
    img = torch.as_tensor(run["images"][0])
    for regularize, want in ((False, 0), (True, 1)):
        calls.clear()
        state, aux = CT.coarse_step(state, cam, img, run["pcfg"], regularize,
                                    torch.Generator().manual_seed(0))
        assert len(calls) == want and bool(torch.isfinite(aux.loss))


def test_normal_term_at_isotropic_scales():
    """Three equal scales: both packages take the first axis as the
    normal; the term and its gradients agree."""
    from autovfx_tpu.sugar import regularization as JREG
    from autovfx_tpu_torch.sugar import regularization as REG

    a = shell_arrays()
    a["quats"] = np.random.default_rng(2).standard_normal(
        a["quats"].shape).astype(np.float32)
    g = jax_gaussians(a)
    key = jax.random.PRNGKey(1)
    fields = ("xyz", "quats", "log_scales", "opacity_logit")

    def loss(params):
        gg = g.replace(**params)
        return JREG.normal_consistency_loss(
            gg, JREG.sample_sdf_points(gg, key, N_SAMPLES))

    val, grads = jax.jit(jax.value_and_grad(loss))(
        {f: getattr(g, f) for f in fields})
    pg = port_gaussians(a)
    params = {f: getattr(pg, f).clone().requires_grad_(True) for f in fields}
    gg = dataclasses.replace(pg, **params)
    got = REG.normal_consistency_loss(gg, REG.sample_sdf_points(
        gg, None, N_SAMPLES, draws=jax_draws(g, key, N_SAMPLES)))
    close(got, float(val), what="normal term")
    for f, gr in zip(fields, torch.autograd.grad(got, list(params.values()))):
        close(gr, grads[f], rtol=GRAD_TOL, what=f"normal term d/d{f}")
