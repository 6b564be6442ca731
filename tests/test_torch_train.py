"""The training slice of the PyTorch port vs the JAX package, on the CPU.

Inputs come from the JAX package's seeded scenes or from numpy, and are
carried across as arrays (``autovfx_tpu_torch.convert``).  On CPU
tensors the port's ``rasterize`` runs the plain versions of its kernels,
and its gradients are ``PreprocessFn`` and ``BlendFn``'s plain
backwards.  Tolerances:

- gradients of every parameter field and of ``mean2d_offset`` against
  ``jax.grad`` through JAX ``rasterize(backend="ref")``: per field, the
  error over the field's largest magnitude below 5e-4, at tile 16 and
  tile 32 (the scenes keep opacity < 0.99, where the reference's clamp
  gradient and CUDA's straight-through one agree);
- finite differences at ``tests/test_rasterizer.py:112-135``'s bounds:
  2e-3 + 5 % for xyz, 1e-4 + 5 % for the opacity logit;
- every loss at rtol 1e-5; Adam from the same gradients, densify with
  JAX's split noise injected, and ``reset_opacity``: counts and masks
  exactly, values at 1e-6; one ``train_step``'s loss, PSNR and densify
  stats at 1e-4 relative (1e-5 for the loss and PSNR).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.core.gaussians import Gaussians as JGaussians
from autovfx_tpu.ops.rasterize import RasterConfig as JConfig
from autovfx_tpu.ops.rasterize import rasterize as j_rasterize
from autovfx_tpu.train import densify as JD
from autovfx_tpu.train import losses as JL
from autovfx_tpu.train import trainer as JT
from autovfx_tpu.utils.synthetic import make_scene
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.train import densify as D
from autovfx_tpu_torch.train import losses as L
from autovfx_tpu_torch.train import trainer as T

PARAMS = ("xyz", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logit")
BUDGET = 1 << 14


def port_gaussians(g) -> Gaussians:
    return convert.gaussians({f: np.asarray(getattr(g, f))
                              for f in convert.GAUSSIAN_FIELDS},
                             device="cpu")


def port_camera(cam) -> C.Camera:
    return convert.camera({f: np.asarray(getattr(cam, f))
                           if f not in ("width", "height") else getattr(cam, f)
                           for f in convert.CAMERA_FIELDS},
                          device="cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def assert_field_close(got, want, atol, what):
    a = np.asarray(want, np.float64)
    b = np.asarray(got, np.float64)
    assert np.isfinite(b).all(), what
    scale = np.abs(a).max() + 1e-6
    err = np.abs(b - a).max() / scale
    assert err < atol, (what, err)


# ---- gradients of the differentiable rasterize --------------------------------


@pytest.mark.parametrize("tile,n,w,h,key", [(16, 120, 48, 32, 1),
                                            (32, 160, 64, 48, 4)])
def test_gradients_match_jax_grad(tile, n, w, h, key):
    g, cam = make_scene(n=n, width=w, height=h, key=key)
    rng = np.random.default_rng(key)
    gc = rng.standard_normal((h, w, 3)).astype(np.float32)
    gd = (0.1 * rng.standard_normal((h, w))).astype(np.float32)
    ga = (0.2 * rng.standard_normal((h, w))).astype(np.float32)
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    jcfg = JConfig(dup_budget=BUDGET, backend="ref", tile=tile)

    def j_loss(params, offset):
        out = j_rasterize(g.replace(**params), cam, bg=jnp.asarray(bg),
                          config=jcfg, mean2d_offset=offset)
        return (jnp.sum(out.color * gc) + jnp.sum(out.depth * gd)
                + jnp.sum(out.alpha * ga))

    params = {f: getattr(g, f) for f in PARAMS}
    j_params, j_off = jax.grad(j_loss, argnums=(0, 1))(
        params, jnp.zeros((n, 2), jnp.float32))

    gt, ct = port_gaussians(g), port_camera(cam)
    leaves = {f: getattr(gt, f).clone().requires_grad_(True) for f in PARAMS}
    offset = torch.zeros((n, 2), requires_grad=True)
    out = rasterize(dataclasses.replace(gt, **leaves), ct, bg=t(bg),
                    config=RasterConfig(dup_budget=BUDGET, tile=tile),
                    mean2d_offset=offset)
    loss = ((out.color * t(gc)).sum() + (out.depth * t(gd)).sum()
            + (out.alpha * t(ga)).sum())
    loss.backward()
    for f in PARAMS:
        assert_field_close(leaves[f].grad.numpy(), j_params[f], 5e-4, f)
    assert_field_close(offset.grad.numpy(), j_off, 5e-4, "mean2d_offset")
    assert float(offset.grad.abs().max()) > 0


def test_mean2d_offset_render_matches_jax():
    """A nonzero offset, with no gradient asked for, moves the splats and
    their tile rects as in JAX ``rasterize(backend="ref")``."""
    g, cam = make_scene(n=150, width=48, height=32, key=2)
    off = (np.random.default_rng(2).random((150, 2), np.float32) - 0.5) * 12.0
    want = j_rasterize(g, cam, config=JConfig(dup_budget=BUDGET,
                                              backend="ref"),
                       mean2d_offset=jnp.asarray(off))
    got = rasterize(port_gaussians(g), port_camera(cam),
                    config=RasterConfig(dup_budget=BUDGET),
                    mean2d_offset=t(off))
    for f in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=2e-5,
                                   err_msg=f)


def test_finite_differences_xyz_and_opacity():
    g, cam = make_scene(n=20, width=24, height=16, key=1)
    gt, ct = port_gaussians(g), port_camera(cam)
    cfg = RasterConfig(dup_budget=1 << 12)
    target = t(np.random.default_rng(9).random((16, 24, 3), np.float32))

    def loss(xyz, op):
        out = rasterize(dataclasses.replace(gt, xyz=xyz, opacity_logit=op),
                        ct, config=cfg)
        return torch.mean((out.color - target) ** 2)

    xyz = gt.xyz.clone().requires_grad_(True)
    op = gt.opacity_logit.clone().requires_grad_(True)
    g_xyz, g_op = torch.autograd.grad(loss(xyz, op), [xyz, op])
    assert torch.isfinite(g_xyz).all() and torch.isfinite(g_op).all()

    rng = np.random.RandomState(0)
    with torch.no_grad():
        for _ in range(4):
            i, j = rng.randint(0, 20), rng.randint(0, 3)
            eps = 3e-3
            xp, xm = gt.xyz.clone(), gt.xyz.clone()
            xp[i, j] += eps
            xm[i, j] -= eps
            fd = float(loss(xp, gt.opacity_logit)
                       - loss(xm, gt.opacity_logit)) / (2 * eps)
            an = float(g_xyz[i, j])
            assert abs(fd - an) < 2e-3 + 0.05 * abs(fd), (i, j, fd, an)
        for _ in range(4):
            i = rng.randint(0, 20)
            eps = 1e-2
            op_p, op_m = gt.opacity_logit.clone(), gt.opacity_logit.clone()
            op_p[i] += eps
            op_m[i] -= eps
            fd = float(loss(gt.xyz, op_p) - loss(gt.xyz, op_m)) / (2 * eps)
            an = float(g_op[i])
            assert abs(fd - an) < 1e-4 + 0.05 * abs(fd), (i, fd, an)


# ---- losses -------------------------------------------------------------------


def _loss_inputs():
    rng = np.random.default_rng(3)
    f32 = np.float32
    img1 = rng.random((20, 28, 3), f32)
    img2 = np.clip(img1 + 0.1 * rng.standard_normal((20, 28, 3)), 0, 1).astype(f32)
    depth = (rng.random((20, 28)) * 6.0).astype(f32)
    mono = (rng.random((20, 28)) * 80.0 - 10.0).astype(f32)
    n1 = rng.standard_normal((20, 28, 3)).astype(f32)
    n2 = rng.standard_normal((20, 28, 3)).astype(f32)
    op = rng.random(50).astype(f32)
    mask = rng.random(50) > 0.3
    scales = np.exp(rng.standard_normal((50, 3))).astype(f32)
    pts = rng.standard_normal((12, 16, 3)).astype(f32)
    return dict(img1=img1, img2=img2, depth=depth, mono=mono, n1=n1, n2=n2,
                op=op, mask=mask, scales=scales, pts=pts)


LOSSES = {
    "l1": lambda M, a: M.l1_loss(a["img1"], a["img2"]),
    "l2": lambda M, a: M.l2_loss(a["img1"], a["img2"]),
    "ssim": lambda M, a: M.ssim(a["img1"], a["img2"]),
    "photometric": lambda M, a: M.photometric_loss(a["img1"], a["img2"], 0.2),
    "scale_shift": lambda M, a: M.compute_scale_and_shift(
        a["depth"].reshape(-1), a["mono"].reshape(-1) / 25.0,
        a["mono"].reshape(-1) > 0),
    "depth": lambda M, a: M.depth_loss(a["depth"], a["mono"], 5.0),
    "normal_masked": lambda M, a: M.normal_loss(a["n1"], a["n2"], a["depth"],
                                                5.0),
    "normal": lambda M, a: M.normal_loss(a["n1"], a["n2"]),
    "opacity": lambda M, a: M.opacity_loss(a["img1"][..., 0]),
    "sparsity": lambda M, a: M.sparsity_loss(a["op"]),
    "sparsity_masked": lambda M, a: M.sparsity_loss(a["op"], a["mask"]),
    "anisotropic": lambda M, a: M.anisotropic_loss(a["scales"]),
    "anisotropic_masked": lambda M, a: M.anisotropic_loss(a["scales"],
                                                          a["mask"]),
    "psnr": lambda M, a: M.psnr(a["img1"], a["img2"]),
    "depth_to_normal": lambda M, a: M.depth_to_normal(a["pts"]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    a = _loss_inputs()
    want = LOSSES[name](JL, {k: jnp.asarray(v) for k, v in a.items()})
    got = LOSSES[name](L, {k: t(v) for k, v in a.items()})
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)


def test_depth_to_normal_zero_border():
    pts = t(_loss_inputs()["pts"])
    n = L.depth_to_normal(pts)
    assert float(n[0].abs().max()) == float(n[-1].abs().max()) == 0.0
    assert float(n[:, 0].abs().max()) == float(n[:, -1].abs().max()) == 0.0


# ---- Adam, learning rates, state ----------------------------------------------


def _jax_gaussians(n, cap, seed):
    g, _ = make_scene(n=n, width=16, height=16, key=seed)
    return g.pad_to(cap)


def _grads(g, seed):
    rng = np.random.default_rng(seed)
    return {f: rng.standard_normal(np.shape(getattr(g, f))).astype(np.float32)
            for f in PARAMS}


def test_apply_adam_matches_jax():
    jg = _jax_gaussians(40, 48, seed=2)
    cfg_kw = dict(spatial_lr_scale=2.67)
    jcfg, cfg = JT.TrainConfig(**cfg_kw), T.TrainConfig(**cfg_kw)
    jstate = JT.init_state(jg)
    state = T.init_state(port_gaussians(jg))
    jg_cur, jadam = jstate.gaussians, jstate.adam
    g_cur, adam = state.gaussians, state.adam
    for step in range(3):  # the moments carry over
        grads = _grads(jg, seed=10 + step)
        jg_cur, jadam = JT.apply_adam(
            jg_cur, jadam, {f: jnp.asarray(v) for f, v in grads.items()},
            jnp.int32(step), jcfg)
        g_cur, adam = T.apply_adam(g_cur, adam,
                                   {f: t(v) for f, v in grads.items()}, step,
                                   cfg)
    assert adam.count == int(jadam.count) == 3
    for f in PARAMS:
        for got, want in ((getattr(g_cur, f), getattr(jg_cur, f)),
                          (getattr(adam.m, f), getattr(jadam.m, f)),
                          (getattr(adam.v, f), getattr(jadam.v, f))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
    # inactive slots never move
    inactive = ~np.asarray(jg.active)
    np.testing.assert_array_equal(g_cur.xyz.numpy()[inactive],
                                  np.asarray(jg.xyz)[inactive])


@pytest.mark.parametrize("step", [0, 1, 777, 30_000, 45_000])
def test_learning_rates_match_jax(step):
    cfg_kw = dict(spatial_lr_scale=2.67)
    want = JT.field_lrs(jnp.int32(step), JT.TrainConfig(**cfg_kw))
    got = T.field_lrs(step, T.TrainConfig(**cfg_kw))
    for f in PARAMS:
        np.testing.assert_allclose(got[f], float(want[f]), rtol=1e-6)


def test_create_pad_compact_match_jax():
    rng = np.random.default_rng(5)
    xyz = rng.standard_normal((30, 3)).astype(np.float32)
    rgb = rng.random((30, 3), np.float32)
    scale = (0.01 + rng.random(30)).astype(np.float32)
    jg = JGaussians.create(jnp.asarray(xyz), jnp.asarray(rgb),
                           initial_scale=jnp.asarray(scale)).pad_to(40)
    g = Gaussians.create(t(xyz), t(rgb), initial_scale=t(scale)).pad_to(40)
    for f in convert.GAUSSIAN_FIELDS:
        np.testing.assert_allclose(getattr(g, f).numpy(),
                                   np.asarray(getattr(jg, f)), rtol=1e-6,
                                   err_msg=f)
    assert int(g.num_active) == int(jg.num_active) == 30
    active = g.active.clone()
    active[::3] = False
    jc = jg.replace(active=jnp.asarray(active.numpy())).compact()
    pc = dataclasses.replace(g, active=active).compact()
    assert pc.capacity == jc.capacity
    np.testing.assert_allclose(pc.xyz.numpy(), np.asarray(jc.xyz))
    with pytest.raises(ValueError, match="shrink"):
        g.pad_to(10)


def test_ray_directions_match_jax():
    jcam = JC.look_at_camera([2.0, 1.0, 1.5], [0, 0, 0], [0, 0, 1], fx=30.0,
                             fy=31.0, width=20, height=14)
    np.testing.assert_allclose(port_camera(jcam).ray_directions().numpy(),
                               np.asarray(jcam.ray_directions()), rtol=1e-6,
                               atol=1e-6)
    batch = C.stack_cameras([port_camera(jcam)] * 3)
    assert C.num_cameras(batch) == 3


def _regularized(pseudo_normal: float):
    g, cam = make_scene(n=120, width=40, height=32, key=3)
    rng = np.random.default_rng(3)
    rgb = rng.random((32, 40, 3), np.float32)
    depth = (rng.random((32, 40)) * 100.0).astype(np.float32)
    normal = rng.standard_normal((32, 40, 3)).astype(np.float32)
    kw = dict(lambda_depth=0.3, lambda_normal=0.2,
              lambda_pseudo_normal=pseudo_normal, lambda_alpha=0.05,
              lambda_anisotropic=0.01)
    jcfg = JT.TrainConfig(raster=JConfig(dup_budget=BUDGET, backend="ref"),
                          **kw)
    cfg = T.TrainConfig(raster=RasterConfig(dup_budget=BUDGET), **kw)

    def j_loss(params):
        return JT.compute_loss(g.replace(**params), jnp.zeros((120, 2)), cam,
                               jnp.asarray(rgb), jcfg, jnp.asarray(depth),
                               jnp.asarray(normal))[0]

    j_val, j_grads = jax.value_and_grad(j_loss)(
        {f: getattr(g, f) for f in PARAMS})
    gt = port_gaussians(g)
    leaves = {f: getattr(gt, f).clone().requires_grad_(True) for f in PARAMS}
    loss = T.compute_loss(dataclasses.replace(gt, **leaves),
                          torch.zeros((120, 2)), port_camera(cam), t(rgb),
                          cfg, t(depth), t(normal))[0]
    loss.backward()
    return (loss.item(), {f: v.grad.numpy() for f, v in leaves.items()},
            float(j_val), j_grads)


def test_compute_loss_with_the_regularizers_matches_jax():
    """Depth, normal (a second pass with normals as override colors),
    alpha and anisotropic terms on: the loss at rtol 1e-5 and every
    parameter's gradient, per field within 1e-3 of its largest
    magnitude."""
    loss, grads, j_loss, j_grads = _regularized(pseudo_normal=0.0)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    for f in PARAMS:
        assert_field_close(grads[f], j_grads[f], 1e-3, f)


def test_pseudo_normal_gradient_is_finite_where_the_reference_is_nan():
    """With the pseudo-normal term on, the loss matches JAX, but where no
    splat covers a pixel its back-projected point is the camera center,
    the cross product is zero, and ``jnp.linalg.norm``'s gradient there
    is NaN, so the reference's gradients are NaN.  The port's norm has a
    zero gradient at zero: finite gradients (a known reference defect,
    not copied)."""
    loss, grads, j_loss, j_grads = _regularized(pseudo_normal=0.1)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert np.isnan(np.asarray(j_grads["xyz"])).any()
    for f in PARAMS:
        assert np.isfinite(grads[f]).all(), f


# ---- one train step -------------------------------------------------------------


def test_train_step_matches_jax():
    g, cam = make_scene(n=150, width=48, height=32, key=6)
    g = g.pad_to(160)
    target = np.random.default_rng(6).random((32, 48, 3), np.float32)
    jcfg = JT.TrainConfig(raster=JConfig(dup_budget=BUDGET, backend="ref"))
    cfg = T.TrainConfig(raster=RasterConfig(dup_budget=BUDGET))
    jstate, jaux = JT.train_step(JT.init_state(g), cam, jnp.asarray(target),
                                 jcfg)
    state, aux = T.train_step(T.init_state(port_gaussians(g)),
                              port_camera(cam), t(target), cfg)
    np.testing.assert_allclose(float(aux.loss), float(jaux.loss), rtol=1e-5)
    np.testing.assert_allclose(float(aux.psnr), float(jaux.psnr), rtol=1e-5)
    assert bool(aux.overflow) == bool(jaux.overflow) is False
    assert state.step == int(jstate.step) == 1
    np.testing.assert_array_equal(state.stats.max_radii.numpy(),
                                  np.asarray(jstate.stats.max_radii))
    np.testing.assert_array_equal(state.stats.denom.numpy(),
                                  np.asarray(jstate.stats.denom))
    assert_field_close(state.stats.grad_accum.numpy(),
                       jstate.stats.grad_accum, 1e-4, "grad_accum")


# ---- densification ---------------------------------------------------------------


def _densify_inputs(case):
    """(JAX Gaussians, JAX stats, kwargs) of a case with clones, splits
    and prunes; "full" leaves too few free slots, so some are dropped."""
    n, cap = 64, 96 if case == "full" else 160
    g, _ = make_scene(n=n, width=16, height=16, key=7)
    rng = np.random.default_rng(7)
    log_s = np.log(rng.uniform(0.002, 0.03, (n, 3))).astype(np.float32)
    logit = rng.uniform(-7.0, 3.0, n).astype(np.float32)
    g = g.replace(log_scales=jnp.asarray(log_s),
                  opacity_logit=jnp.asarray(logit)).pad_to(cap)
    stats = JD.DensifyStats(
        grad_accum=jnp.asarray(rng.uniform(0, 2e-3, cap).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 4, cap).astype(np.float32)),
        max_radii=jnp.asarray(rng.integers(0, 40, cap).astype(np.int32)),
    )
    kw = dict(extent=2.0, percent_dense=0.01)
    if case == "screen_size":
        kw["max_screen_size"] = 20
    return g, stats, kw


@pytest.mark.parametrize("case", ["free", "full", "screen_size"])
def test_densify_and_prune_matches_jax(case):
    jg, jstats, kw = _densify_inputs(case)
    key = jax.random.PRNGKey(11)
    want = JD.densify_and_prune(jg, jstats, key, **kw)
    noise = t(jax.random.normal(key, (jg.capacity, 3)))
    stats = D.DensifyStats(*(t(getattr(jstats, f)) for f in
                             ("grad_accum", "denom", "max_radii")))
    got = D.densify_and_prune(port_gaussians(jg), stats, noise=noise, **kw)
    for f in ("n_cloned", "n_split", "n_pruned", "dropped"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert int(got.n_cloned) > 0 and int(got.n_split) > 0
    assert int(got.n_pruned) > int(got.n_split)  # low opacity too
    if case == "full":
        assert int(got.dropped) > 0
    np.testing.assert_array_equal(got.new_mask.numpy(),
                                  np.asarray(want.new_mask))
    np.testing.assert_array_equal(got.gaussians.active.numpy(),
                                  np.asarray(want.gaussians.active))
    for f in PARAMS:
        np.testing.assert_allclose(getattr(got.gaussians, f).numpy(),
                                   np.asarray(getattr(want.gaussians, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert float(got.stats.grad_accum.abs().max()) == 0.0
    n_after = int(got.gaussians.num_active)
    n_before = int(jg.num_active)
    assert n_after == (n_before + int(got.n_cloned) + 2 * int(got.n_split)
                       - int(got.n_pruned) - int(got.dropped))


def test_densify_and_reset_steps_match_jax():
    jg, jstats, _ = _densify_inputs("free")
    key = jax.random.PRNGKey(12)
    jcfg = JT.TrainConfig(spatial_lr_scale=2.0)
    cfg = T.TrainConfig(spatial_lr_scale=2.0)
    grads = _grads(jg, seed=3)
    js = JT.init_state(jg)
    g1, ad1 = JT.apply_adam(js.gaussians, js.adam,
                            {f: jnp.asarray(v) for f, v in grads.items()},
                            jnp.int32(0), jcfg)
    js = js.replace(gaussians=g1, adam=ad1, stats=jstats)
    js, jres = JT.densify_step(js, key, jcfg, 600)
    js = JT.reset_opacity_step(js)

    ps = T.init_state(port_gaussians(jg))
    g1, ad1 = T.apply_adam(ps.gaussians, ps.adam,
                           {f: t(v) for f, v in grads.items()}, 0, cfg)
    stats = D.DensifyStats(*(t(getattr(jstats, f)) for f in
                             ("grad_accum", "denom", "max_radii")))
    ps = dataclasses.replace(ps, gaussians=g1, adam=ad1, stats=stats)
    ps, res = T.densify_step(ps, None, cfg, 600,
                             noise=t(jax.random.normal(key, (jg.capacity, 3))))
    ps = T.reset_opacity_step(ps)
    assert int(res.n_split) == int(jres.n_split)
    for f in PARAMS:
        for got, want in ((getattr(ps.gaussians, f), getattr(js.gaussians, f)),
                          (getattr(ps.adam.m, f), getattr(js.adam.m, f)),
                          (getattr(ps.adam.v, f), getattr(js.adam.v, f))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
    assert float(ps.gaussians.opacity.max()) <= 0.01 + 1e-7


def test_reset_opacity_matches_jax():
    g, _ = make_scene(n=50, width=16, height=16, key=8)
    want = np.asarray(JD.reset_opacity(g).opacity_logit)
    got = D.reset_opacity(port_gaussians(g)).opacity_logit.numpy()
    np.testing.assert_array_equal(got, want)


def test_densify_draws_from_the_generator():
    jg, jstats, kw = _densify_inputs("free")
    stats = D.DensifyStats(*(t(getattr(jstats, f)) for f in
                             ("grad_accum", "denom", "max_radii")))
    runs = [D.densify_and_prune(port_gaussians(jg), stats,
                                torch.Generator().manual_seed(s), **kw)
            for s in (1, 1, 2)]
    assert torch.equal(runs[0].gaussians.xyz, runs[1].gaussians.xyz)
    assert not torch.equal(runs[0].gaussians.xyz, runs[2].gaussians.xyz)


# ---- end to end ------------------------------------------------------------------


@pytest.mark.slow
def test_fit_improves_psnr():
    """``tests/test_training.py``'s end-to-end fit, through the port."""
    gt_g, _ = make_scene(n=120, width=48, height=36, key=0)
    gt_g = port_gaussians(gt_g)
    cfg_r = RasterConfig(dup_budget=1 << 13)
    cams = C.stack_cameras([
        C.look_at_camera([3 * np.cos(a), 3 * np.sin(a), 1.0], [0, 0, 0],
                         [0, 0, 1], fx=40.0, fy=40.0, width=48, height=36,
                         device="cpu")
        for a in np.linspace(0, 2 * np.pi, 6, endpoint=False)])
    imgs = torch.stack([rasterize(gt_g, C.index_camera(cams, i),
                                  config=cfg_r).color for i in range(6)])
    noise = np.random.default_rng(7).standard_normal((120, 3))
    pts = gt_g.xyz + 0.05 * t(noise.astype(np.float32))
    g0 = T.init_gaussians_from_points(pts, torch.full((120, 3), 0.5)).pad_to(256)
    cfg = T.TrainConfig(iterations=150, raster=cfg_r, densify_from_iter=50,
                        densification_interval=50,
                        opacity_reset_interval=10_000, spatial_lr_scale=2.0)
    state, hist = T.train(g0, cams, imgs, cfg, log_every=150)
    cam0 = C.index_camera(cams, 0)
    p0 = float(L.psnr(rasterize(g0, cam0, config=cfg_r).color, imgs[0]))
    p1 = float(L.psnr(rasterize(state.gaussians, cam0, config=cfg_r).color,
                      imgs[0]))
    assert p1 > p0 + 3.0, (p0, p1)
    assert hist and hist[-1]["iter"] == 150
