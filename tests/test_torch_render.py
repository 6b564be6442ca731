"""The port's edited-frame render modules against the JAX package's, on
the CPU: ``render/envmap``, ``render/ibl``, ``render/meshsplat``,
``render/shadow``, ``render/composite`` and ``render/emitter``.

The same seeded numpy inputs go through both.  Budgets:

- envmap, ibl (with and without the GGX stack), meshsplat, composite,
  emitter: elementwise within 1e-5 of each output's largest magnitude;
- ``importance_directions``: equal texels and multiplicities, directions
  within 1e-6, weights within 1e-5 relative;
- ``ray_hits_hull``, ``shadow_ratio_map`` (scale 1 and 2, and an odd
  image size) and ``hull_object_weight``: equal on ≥ 99.9 % of pixels
  (their decisions are thresholds, which rounding can flip);
- the closed-form shadow oracles of ``tests/test_golden_clip.py``
  (sphere) and ``tests/test_shadow_oracle.py`` (dense f64 integral),
  run through the port at their own bounds.

``test_importance_directions_below_horizon_is_finite_where_the_reference_is_nan``
pins where the port departs from the reference on purpose.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.render import composite as JCOMP
from autovfx_tpu.render import emitter as JEM
from autovfx_tpu.render import envmap as JENV
from autovfx_tpu.render import ibl as JIBL
from autovfx_tpu.render import meshsplat as JMS
from autovfx_tpu.render import shadow as JSH
from autovfx_tpu_torch.core.cameras import look_at_camera
from autovfx_tpu_torch.render import composite as COMP
from autovfx_tpu_torch.render import emitter as EM
from autovfx_tpu_torch.render import envmap as ENV
from autovfx_tpu_torch.render import ibl as IBL
from autovfx_tpu_torch.render import meshsplat as MS
from autovfx_tpu_torch.render import shadow as SH

sys.path.insert(0, os.path.dirname(__file__))

REL = 1e-5  # of each output's largest magnitude
AGREE = 0.999  # share of pixels on which a decided output must agree


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= rel * scale, (err, scale)


def unit(rng, *shape):
    v = rng.standard_normal(shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def env():
    rng = np.random.RandomState(1)
    return (0.3 + 0.7 * rng.rand(16, 32, 3)).astype(np.float32)


# ---- envmap -------------------------------------------------------------------


def test_direction_uv_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    d = unit(rng, 500)
    close(ENV.direction_to_uv(t(d)), JENV.direction_to_uv(jnp.asarray(d)))
    uv = rng.random((500, 2)).astype(np.float32)
    close(ENV.uv_to_direction(t(uv)), JENV.uv_to_direction(jnp.asarray(uv)))


def test_sample_envmap_matches_jax(env):
    d = unit(np.random.default_rng(1), 2000)
    # the seam (u = 0 / 1) and the poles wrap and clamp
    d[:4] = [[-1e-7, 1e-3, 0.2], [1e-7, -1e-3, 0.2], [0, 0, 1], [0, 0, -1]]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    close(ENV.sample_envmap(t(env), t(d)),
          JENV.sample_envmap(jnp.asarray(env), jnp.asarray(d)))


def test_rotate_envmap_and_sun_match_jax(env):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(np.random.default_rng(2).standard_normal(
        (3, 3)))[0].astype(np.float32)
    close(ENV.rotate_envmap_cam_to_world(t(env), t(c2w)),
          JENV.rotate_envmap_cam_to_world(jnp.asarray(env), jnp.asarray(c2w)))
    close(ENV.sun_direction(t(env)), JENV.sun_direction(jnp.asarray(env)))


def _texels(dirs, h, w):
    uv = np.asarray(JENV.direction_to_uv(jnp.asarray(dirs)))
    return (np.round(uv[:, 1] * h - 0.5).astype(int) * w
            + np.round(uv[:, 0] * w - 0.5).astype(int) % w)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(up=np.array([0.0, 0.0, 1.0])),
    dict(up=np.array([0.0, 0.0, 1.0]), stratified=True, dedup=True),
    dict(up=np.array([0.0, 0.0, 1.0]), stratified=True),
])
def test_importance_directions_match_jax(env, kw):
    got = ENV.importance_directions(env, 24, seed=3, **kw)
    want = JENV.importance_directions(env, 24, seed=3, **kw)
    h, w, _ = env.shape
    assert np.array_equal(_texels(got[0], h, w), _texels(want[0], h, w))
    assert np.abs(got[0] - want[0]).max() <= 1e-6
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)


def test_importance_directions_below_horizon_is_finite_where_the_reference_is_nan():
    """All the energy below the horizon: the reference divides by a zero
    density sum; the port samples the un-cosined density instead."""
    env = np.zeros((16, 32, 3), np.float32)
    env[12:] = 1.0  # the lower hemisphere only
    up = np.array([0.0, 0.0, 1.0])
    with np.errstate(invalid="ignore", divide="ignore"):
        ref = JENV.importance_directions(env, 8, up=up, stratified=True)
    assert not all(np.isfinite(x).all() for x in ref)  # NaN weights
    dirs, contrib = ENV.importance_directions(env, 8, up=up, stratified=True)
    assert np.isfinite(dirs).all() and np.isfinite(contrib).all()
    assert (dirs[:, 2] < 0).all()  # drawn where the energy is
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=-1), 1.0, atol=1e-6)
    assert (contrib == 0).all()  # no energy reaches an up-facing catcher
    # a black envmap: uniform directions with zero weight, still finite
    dirs, contrib = ENV.importance_directions(np.zeros_like(env), 8, up=up)
    assert np.isfinite(dirs).all() and (contrib == 0).all()


def test_load_envmap_npy(tmp_path, env):
    p = str(tmp_path / "env.npy")
    np.save(p, env)
    assert np.array_equal(ENV.load_envmap(p), JENV.load_envmap(p))


# ---- ibl ----------------------------------------------------------------------


def test_envmap_sh9_and_irradiance_match_jax(env):
    sh = IBL.envmap_sh9(env)
    close(sh, JIBL.envmap_sh9(env))
    n = unit(np.random.default_rng(3), 700)
    close(IBL.sh_irradiance(t(sh), t(n)),
          JIBL.sh_irradiance(jnp.asarray(sh), jnp.asarray(n)))


@pytest.fixture(scope="module")
def ggx(env):
    kw = dict(levels=3, out_hw=(8, 16), samples=16)
    return (IBL.prefilter_envmap_ggx(env, device="cpu", **kw),
            JIBL.prefilter_envmap_ggx(env, **kw))


def test_prefilter_envmap_ggx_matches_jax(ggx):
    close(*ggx)


@pytest.mark.parametrize("with_ggx", [False, True])
def test_shade_matches_jax(env, ggx, with_ggx):
    rng = np.random.default_rng(4)
    n = unit(rng, 600)
    v = -n * 0.6 + unit(rng, 600) * 0.4
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    base = rng.random((600, 3)).astype(np.float32)
    rough = rng.random((600, 1)).astype(np.float32)
    metal = (rng.random((600, 1)) > 0.5).astype(np.float32)
    emission = 0.1 * rng.random((600, 3)).astype(np.float32)
    sh = IBL.envmap_sh9(env)
    stack = ggx[1] if with_ggx else None
    got = IBL.shade(t(n), t(v), t(env), t(sh), t(base), t(rough), t(metal),
                    emission=t(emission),
                    env_ggx=None if stack is None else t(stack))
    want = JIBL.shade(jnp.asarray(n), jnp.asarray(v), jnp.asarray(env),
                      jnp.asarray(sh), jnp.asarray(base), jnp.asarray(rough),
                      jnp.asarray(metal), emission=jnp.asarray(emission),
                      env_ggx=None if stack is None else jnp.asarray(stack))
    close(got, want)


def test_env_brdf_and_stack_lookup_match_jax(ggx):
    rng = np.random.default_rng(5)
    ndv = rng.random((300, 1)).astype(np.float32)
    r = rng.random((300, 1)).astype(np.float32)
    for a, b in zip(IBL.env_brdf_approx(t(ndv), t(r)),
                    JIBL.env_brdf_approx(jnp.asarray(ndv), jnp.asarray(r))):
        close(a, b)
    d = unit(rng, 300)
    rr = rng.random(300).astype(np.float32)
    close(IBL.sample_envmap_stack(t(ggx[1]), t(d), t(rr)),
          JIBL.sample_envmap_stack(jnp.asarray(ggx[1]), jnp.asarray(d),
                                   jnp.asarray(rr)))


def _box_mesh():
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32) * [2.0, 2.0, 0.1]
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int64)
    return v.astype(np.float32), f


def test_mirror_scene_reflection_matches_jax(env):
    v, f = _box_mesh()
    rng = np.random.default_rng(6)
    pts = (rng.random((200, 3)) * [2, 2, 1] - [1, 1, -0.5]).astype(np.float32)
    dirs = unit(rng, 200)
    dirs[:, 2] = -np.abs(dirs[:, 2])  # mostly toward the slab
    col = rng.random((len(f), 3)).astype(np.float32)
    sh = IBL.envmap_sh9(env)
    tri = [v[f[:, i]] for i in range(3)]
    got = IBL.mirror_scene_reflection(t(pts), t(dirs), *map(t, tri), t(col),
                                      t(sh))
    want = JIBL.mirror_scene_reflection(
        jnp.asarray(pts), jnp.asarray(dirs), *map(jnp.asarray, tri),
        jnp.asarray(col), jnp.asarray(sh))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any()
    close(got[0], want[0])


# ---- meshsplat ----------------------------------------------------------------


def _cube():
    corners = np.array([[x, y, z] for x in (-0.3, 0.3) for y in (-0.3, 0.3)
                        for z in (-0.3, 0.3)], np.float32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                      [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                      [1, 5, 7], [1, 7, 3]], np.int64)
    return corners, faces


@pytest.mark.parametrize("colors", ["default", "vertex", "texture"])
def test_sample_mesh_surfels_equal_jax(colors):
    v, f = _cube()
    rng = np.random.default_rng(7)
    kw = {}
    if colors == "vertex":
        kw["vertex_colors"] = rng.random((8, 3))
    elif colors == "texture":
        kw["uv"] = rng.random((8, 2))
        kw["texture"] = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
    got = MS.sample_mesh_surfels(v, f, num_samples=500, seed=2, device="cpu",
                                 **kw)
    want = JMS.sample_mesh_surfels(v, f, num_samples=500, seed=2, **kw)
    for k in MS.SURFEL_FIELDS:
        assert np.array_equal(got[k].numpy(), want[k]), k


def _object_case(env):
    """A transformed, shaded object with a mirror's scene bounce and an
    emitter: (surfels, sh, kwargs as numpy)."""
    v, f = _cube()
    s = JMS.sample_mesh_surfels(v, f, num_samples=400, seed=1)
    rng = np.random.default_rng(8)
    rot = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    mv, mf = _box_mesh()
    em = dict(points=(rng.random((5, 3)) + [0, 0, 1.5]).astype(np.float32),
              normals=unit(rng, 5), radiance=rng.random((5, 3)).astype(
                  np.float32), areas=rng.random(5).astype(np.float32))
    kw = dict(
        cam_center=np.array([2.0, 1.0, 1.5], np.float32),
        base_color=np.float32([0.8, 0.3, 0.2]), roughness=0.3, metallic=0.5,
        transform=(1.5, rot, np.array([0.1, -0.2, 0.5], np.float32)),
        mirror_scene=[mv[mf[:, i]] for i in range(3)]
        + [rng.random((len(mf), 3)).astype(np.float32)],
        emitter=em)
    return s, IBL.envmap_sh9(env), kw


def _port_object(s, env, sh, kw):
    return MS.shaded_object_gaussians(
        {k: t(x) for k, x in s.items()}, t(env), t(sh), t(kw["cam_center"]),
        base_color=t(kw["base_color"]), roughness=kw["roughness"],
        metallic=kw["metallic"],
        transform=(kw["transform"][0],) + tuple(map(t, kw["transform"][1:])),
        mirror_scene=tuple(map(t, kw["mirror_scene"])),
        emitter=EM.EmitterLights(**{k: t(x)
                                    for k, x in kw["emitter"].items()}))


def _jax_object_unit_views(s, env, sh, kw):
    """JAX's meshsplat.shaded_object_gaussians, step for step from the
    JAX package's own functions, with unit view directions."""
    from autovfx_tpu.utils.linalg import apply_rotation

    j = jnp.asarray
    sc, r, tr = kw["transform"]
    pts = apply_rotation(j(s["points"]) * sc, j(r)) + j(tr)
    nrm = apply_rotation(j(s["normals"]), j(r))
    view = pts - j(kw["cam_center"])[None]
    view = view / jnp.maximum(jnp.linalg.norm(view, axis=-1, keepdims=True),
                              1e-12)
    nrm_s = jnp.where(jnp.sum(nrm * view, -1, keepdims=True) > 0, -nrm, nrm)
    albedo = j(s["colors"]) * j(kw["base_color"])
    ndv = jnp.maximum(jnp.sum(nrm_s * (-view), -1, keepdims=True), 0.0)
    spec, hit = JIBL.mirror_scene_reflection(
        pts, 2.0 * ndv * nrm_s + view, *map(j, kw["mirror_scene"]), j(sh))
    shaded = JIBL.shade(nrm_s, view, j(env), j(sh), albedo,
                        roughness=kw["roughness"], metallic=kw["metallic"],
                        scene_spec=spec, scene_spec_mask=hit[:, None])
    shaded = shaded + albedo * JEM.emitter_irradiance(
        pts, nrm_s, JEM.EmitterLights(**{k: j(x)
                                         for k, x in kw["emitter"].items()}))
    return JMS.surfels_to_gaussians(pts, nrm_s, shaded,
                                    float(s["radius"]) * sc)


def _close_gaussians(got, want):
    for name in ("xyz", "sh_dc", "sh_rest", "log_scales", "opacity_logit"):
        close(getattr(got, name), getattr(want, name))
    a, b = got.quats.numpy(), np.asarray(want.quats)
    close(a * np.sign((a * b).sum(-1, keepdims=True)), b)  # q and -q agree


def test_shaded_object_gaussians_match_jax(env):
    """meshsplat's transform + shade + splat (a mirror's scene bounce, an
    emitter) against the same steps of the JAX package, each field within
    1e-5 of its largest magnitude."""
    s, sh, kw = _object_case(env)
    _close_gaussians(_port_object(s, env, sh, kw),
                     _jax_object_unit_views(s, env, sh, kw))


def test_shaded_object_views_are_unit_where_the_reference_scales_them_by_a_matrix_norm(env):
    """The reference normalizes the view directions with
    ``jnp.linalg.norm(view, -1, keepdims=True)`` (``meshsplat.py:171``),
    whose -1 is the matrix norm's ``ord``, not an axis: one scalar for
    all surfels, so its views are not unit and its shading is off.  The
    port normalizes each row."""
    s, sh, kw = _object_case(env)
    want = _jax_object_unit_views(s, env, sh, kw)
    j = jnp.asarray
    ref = JMS.shaded_object_gaussians(
        s, j(env), j(sh), j(kw["cam_center"]), base_color=j(kw["base_color"]),
        roughness=kw["roughness"], metallic=kw["metallic"],
        transform=(kw["transform"][0],) + tuple(map(j, kw["transform"][1:])),
        mirror_scene=tuple(map(j, kw["mirror_scene"])),
        emitter=JEM.EmitterLights(**{k: j(x)
                                     for k, x in kw["emitter"].items()}))
    assert np.abs(np.asarray(ref.sh_dc) - np.asarray(want.sh_dc)).max() > 0.1
    _close_gaussians(_port_object(s, env, sh, kw), want)


def test_emitter_irradiance_matches_jax():
    rng = np.random.default_rng(9)
    pts = rng.random((300, 3)).astype(np.float32)
    n = unit(rng, 300)
    em = dict(points=(rng.random((7, 3)) + [0, 0, 1]).astype(np.float32),
              normals=unit(rng, 7), radiance=rng.random((7, 3)).astype(
                  np.float32), areas=rng.random(7).astype(np.float32))
    close(EM.emitter_irradiance(t(pts), t(n), EM.EmitterLights(
        **{k: t(x) for k, x in em.items()})),
        JEM.emitter_irradiance(jnp.asarray(pts), jnp.asarray(n),
                               JEM.EmitterLights(**{k: jnp.asarray(x)
                                                    for k, x in em.items()})))


# ---- shadow -------------------------------------------------------------------


def _hulls():
    """Two boxes' planes in the world frame, padded to 8 with a masked
    slot, (B, F, 4) and (B, F)."""
    planes = np.zeros((2, 8, 4), np.float32)
    mask = np.zeros((2, 8), bool)
    for b, (lo, hi) in enumerate((([-0.3, -0.3, 0.4], [0.3, 0.3, 1.0]),
                                  ([0.5, 0.2, 0.1], [0.8, 0.6, 0.5]))):
        n = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float32)
        d = np.array([hi[0], -lo[0], hi[1], -lo[1], hi[2], -lo[2]])
        planes[b, :6, :3], planes[b, :6, 3] = n, d
        mask[b, :6] = True
    return planes, mask


def _cams(w, h):
    kw = dict(fx=0.9 * w, fy=0.9 * w, width=w, height=h)
    return (look_at_camera([2.4, 1.2, 2.0], [0, 0, 0.2], [0, 0, 1],
                           device="cpu", **kw),
            JC.look_at_camera([2.4, 1.2, 2.0], [0, 0, 0.2], [0, 0, 1], **kw))


def test_ray_hits_hull_matches_jax():
    planes, mask = _hulls()
    rng = np.random.default_rng(10)
    o = (rng.random((4000, 3)) * 2 - 1).astype(np.float32)
    d = unit(rng, 4000)
    got = SH.ray_hits_hull(t(o), t(d), t(planes[0]), t(mask[0])).numpy()
    want = np.asarray(JSH.ray_hits_hull(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(planes[0]),
                                        jnp.asarray(mask[0])))
    assert (got == want).mean() >= AGREE
    assert 0.05 < want.mean() < 0.95


def _depth_alpha(w, h, rng):
    depth = (2.5 + 0.3 * rng.random((h, w))).astype(np.float32)
    alpha = np.clip(0.6 + 0.5 * rng.random((h, w)), 0, 1).astype(np.float32)
    return depth * alpha, alpha


@pytest.mark.parametrize("w,h,scale", [(48, 32, 1), (48, 32, 2),
                                       (47, 31, 2), (67, 63, 2)])
def test_shadow_ratio_map_matches_jax(w, h, scale):
    cam, jcam = _cams(w, h)
    planes, mask = _hulls()
    rng = np.random.default_rng(11)
    depth, alpha = _depth_alpha(w, h, rng)
    dirs = unit(rng, 12)
    dirs[:, 2] = np.abs(dirs[:, 2])
    wts = rng.random(12).astype(np.float32)
    got = SH.shadow_ratio_map(cam, t(depth), t(alpha), t(dirs), t(wts),
                              t(planes), t(mask), scale=scale).numpy()
    want = np.asarray(JSH.shadow_ratio_map(
        jcam, jnp.asarray(depth), jnp.asarray(alpha), jnp.asarray(dirs),
        jnp.asarray(wts), jnp.asarray(planes), jnp.asarray(mask),
        scale=scale))
    assert got.shape == want.shape == (h, w)
    assert (np.abs(got - want) <= 1e-5).mean() >= AGREE
    assert want.min() < 0.99  # some shadow in view


@pytest.mark.parametrize("w,h", [(64, 64), (63, 65)])
def test_shadow_resampling_matches_jax(w, h):
    """The box downsample (edge-padded) and the bilinear upsample of the
    shadow pass against JAX's pad/mean and ``jax.image.resize``."""
    import jax

    x = np.random.default_rng(12).random((h, w)).astype(np.float32)
    hs, ws = round(h / 2), round(w / 2)
    got = SH._box_down(t(x), 2, hs, ws).numpy()
    pad = ((0, max(hs * 2 - h, 0)), (0, max(ws * 2 - w, 0)))
    want = np.pad(x, pad, mode="edge")[:hs * 2, :ws * 2].reshape(
        hs, 2, ws, 2).mean(axis=(1, 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    up = torch.nn.functional.interpolate(
        t(got)[None, None], size=(h, w), mode="bilinear",
        align_corners=False, antialias=False)[0, 0].numpy()
    want_up = np.asarray(jax.image.resize(jnp.asarray(got), (h, w),
                                          method="bilinear"))
    np.testing.assert_allclose(up, want_up, rtol=0, atol=1e-6)


def test_hull_object_weight_matches_jax():
    cam, jcam = _cams(64, 48)
    planes, mask = _hulls()
    rng = np.random.default_rng(13)
    scene = (1.5 + 2.0 * rng.random((48, 64))).astype(np.float32)
    got = SH.hull_object_weight(cam, t(scene), t(planes), t(mask),
                                pad=0.02).numpy()
    want = np.asarray(JSH.hull_object_weight(
        jcam, jnp.asarray(scene), jnp.asarray(planes), jnp.asarray(mask),
        pad=0.02))
    assert (got == want).mean() >= AGREE
    assert 0.01 < want.mean() < 0.9


def test_trim_and_world_planes_match_jax():
    planes = np.zeros((2, 64, 4), np.float32)
    mask = np.zeros((2, 64), bool)
    mask[0, :6] = mask[1, :11] = True
    planes[mask] = np.random.default_rng(14).random((17, 4))
    got = SH.trim_hull_planes(t(planes), t(mask))
    want = JSH.trim_hull_planes(planes, mask)
    assert got[0].shape == (2, 16, 4)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    rot = np.linalg.qr(np.random.default_rng(15).standard_normal(
        (3, 3)))[0].astype(np.float32)
    pos = np.float32([0.3, -0.1, 0.7])
    close(SH.world_hull_planes(t(planes[0]), t(mask[0]), t(rot), t(pos))[0],
          JSH.world_hull_planes(jnp.asarray(planes[0]), jnp.asarray(mask[0]),
                                jnp.asarray(rot), jnp.asarray(pos))[0])


class TestShadowOracles:
    """The closed-form oracles of the JAX package's tests, through the
    port, at their own bounds."""

    def test_sphere_center_pixel(self):
        from test_golden_clip import TestSphereShadowOracle

        oracle = TestSphereShadowOracle()
        cam = look_at_camera([0.0, 1e-4, 2.0], [0.0, 0.0, 0.0],
                             [0.0, 1.0, 0.0], fx=64.0, fy=64.0, width=32,
                             height=32, device="cpu")
        planes, mask = oracle._sphere_planes([0.0, 0.0, oracle.HGT])
        dirs = oracle._cosine_dirs(2048)
        ratio = SH.shadow_ratio_map(
            cam, torch.full((32, 32), 2.0), torch.ones(32, 32), t(dirs),
            torch.ones(dirs.shape[0]), t(planes)[None], t(mask)[None],
            bias=1e-3).numpy()
        want = 1.0 - (oracle.R / oracle.HGT) ** 2
        assert abs(ratio[16, 16] - want) < 0.03, (ratio[16, 16], want)
        assert ratio[0, 0] > want + 0.02
        # and the ray test alone, over the cosine-weighted hemisphere
        dirs = oracle._cosine_dirs()
        hit = SH.ray_hits_hull(torch.zeros(dirs.shape[0], 3), t(dirs),
                               t(planes), t(mask)).numpy()
        assert abs((1.0 - hit.mean()) - want) < 0.02

    def test_dense_integral_overhead_map(self):
        import test_shadow_oracle as O

        env = O.synthetic_hdr()
        hpx, wpx = 24, 32
        cam = look_at_camera([0.0, 1e-4, 6.0], [0.0, 0.0, 0.0],
                             [0.0, 1.0, 0.0], fx=40.0, fy=40.0, width=wpx,
                             height=hpx, device="cpu")
        dirs, contrib = ENV.importance_directions(
            env, 64, up=np.array([0.0, 0.0, 1.0]), stratified=True)
        planes, mask = O.box_hull_planes()
        ratio = SH.shadow_ratio_map(
            cam, torch.full((hpx, wpx), 6.0), torch.ones(hpx, wpx), t(dirs),
            t(contrib.sum(-1)), t(planes)[None], t(mask)[None],
            bias=1e-3).numpy()
        rays = cam.ray_directions().numpy()
        pts = (cam.center.numpy()[None, None] + rays * 6.0).reshape(-1, 3)
        pts[:, 2] = 0.0
        ref = O.dense_reference(env, pts).reshape(hpx, wpx)
        err = np.abs(ratio - ref)
        assert err.mean() < 0.04, err.mean()
        assert err.max() < 0.2, err.max()

    def test_dense_integral_k64_points(self):
        import test_shadow_oracle as O

        env = O.synthetic_hdr()
        pts = O.ground_points()
        ref = O.dense_reference(env, pts)
        dirs, contrib = ENV.importance_directions(
            env, 64, up=np.array([0.0, 0.0, 1.0]), stratified=True)
        planes, mask = O.box_hull_planes()
        hits = SH.ray_hits_hull(t(pts[:, None, :].astype(np.float32)),
                                t(dirs)[None], t(planes), t(mask)).numpy()
        w = contrib.sum(-1).astype(np.float64)
        est = ((1.0 - hits) * w[None]).sum(-1) / w.sum()
        err = np.abs(est - ref)
        assert err.mean() < 0.03 and err.max() < 0.15, (err.mean(), err.max())


# ---- composite ----------------------------------------------------------------


@pytest.mark.parametrize("extras", [False, True])
def test_composite_frame_matches_jax(extras):
    rng = np.random.default_rng(16)
    h, w = 24, 32
    img = lambda *c: rng.random((h, w) + c).astype(np.float32)
    fields = dict(
        bg_color=img(3), scene_depth=1.0 + img(), obj_color=img(3),
        obj_alpha=np.where(img() > 0.5, img(), 0).astype(np.float32),
        obj_depth=1.0 + img(), shadow_ratio=np.clip(img() * 1.2, 0, 1),
        catcher_alpha=img())
    if extras:
        fields.update(obj3dgs_alpha=img(), obj3dgs_depth=1.0 + img(),
                      smoke_alpha=img() * 0.5, smoke_depth=1.0 + img(),
                      smoke_color=img(3), fire_premult=img(3) * 0.2)
    got = COMP.composite_frame(COMP.CompositeInputs(
        **{k: t(v) for k, v in fields.items()}))
    want = JCOMP.composite_frame(JCOMP.CompositeInputs(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    close(got, want)
    a, b = img(), img()
    for option in ("naive", "tolerance", "naive_or_tolerance"):
        assert np.array_equal(COMP.depth_check(t(a), t(b), option=option),
                              JCOMP.depth_check(a, b, option=option))


@pytest.mark.parametrize("shape", [(24, 32, 3), (25, 33), (25, 33, 3)])
def test_downsample_match_jax(shape):
    x = np.random.default_rng(17).random(shape).astype(np.float32)
    close(COMP.downsample2x(t(x)), JCOMP.downsample2x(jnp.asarray(x)))
    assert np.array_equal(COMP.downsample2x_nearest(t(x)).numpy(),
                          JCOMP.downsample2x_nearest(jnp.asarray(x)))


# ---- materials (a numpy copy) -------------------------------------------------


def test_materials_match_jax():
    from autovfx_tpu.render import materials as JMAT
    from autovfx_tpu_torch.render import materials as MAT

    rng = np.random.default_rng(18)
    v, f = _cube()
    s = JMS.sample_mesh_surfels(v, f, num_samples=300, seed=3)
    tex = dict(diffuse=rng.random((16, 16, 3)).astype(np.float32),
               roughness=rng.random((16, 16)).astype(np.float32),
               normal=rng.random((16, 16, 3)).astype(np.float32),
               displacement=rng.random((16, 16)).astype(np.float32))
    got = MAT.apply_material_to_surfels(s, MAT.Material(**tex))
    want = JMAT.apply_material_to_surfels(s, JMAT.Material(**tex))
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    cols = rng.random((100, 3)).astype(np.float32)
    assert np.array_equal(MAT.hue_shift_colors(cols, [0.2, 0.5, 0.9]),
                          JMAT.hue_shift_colors(cols, [0.2, 0.5, 0.9]))


def test_object_hulls_world_matches_jax():
    from autovfx_tpu.physics import solver as JS
    from autovfx_tpu.physics.shapes import build_hulls as j_build_hulls
    from autovfx_tpu_torch.physics.shapes import build_hulls
    from autovfx_tpu_torch.physics.solver import BodyState

    v, _ = _cube()
    shape = build_hulls([v, v * 0.5], device="cpu")[0]
    jshape = j_build_hulls([v, v * 0.5])[0]
    rng = np.random.default_rng(19)
    quat = rng.standard_normal((2, 4)).astype(np.float32)
    pos = rng.standard_normal((2, 3)).astype(np.float32)
    zeros = np.zeros((2, 3), np.float32)
    state = BodyState(t(pos), t(quat), t(zeros), t(zeros),
                      torch.zeros(2, dtype=torch.bool),
                      torch.zeros(2, dtype=torch.int32))
    jstate = JS.BodyState(jnp.asarray(pos), jnp.asarray(quat),
                          jnp.asarray(zeros), jnp.asarray(zeros),
                          jnp.zeros(2, bool), jnp.zeros(2, jnp.int32))
    got = SH.object_hulls_world(shape, state)
    want = JSH.object_hulls_world(jshape, jstate)
    close(got[0], want[0])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
