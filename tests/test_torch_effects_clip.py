"""The edited frame with effects, PyTorch port against the JAX package, on
the CPU.

The clip is ``tests/test_clip_fused.py``'s ``_setup`` (a 400-splat ground
carpet, a 3,000-surfel cube, 96×64, tile 16) with a 12³ smoke/fire
volume simulated by the JAX package (fixed, and adaptive for the
5-tuple) and synthetic liquid-melt tracers drifting down over the two
frames, as ``tests/test_clip_fused.py``'s ``_effects_inputs`` builds
them; everything is carried across with ``convert``, so both sides
render the same inputs.  The JAX fused frame runs its Pallas kernels in
interpret mode, as that file does.  Budgets:

- the port's fused frame (exact float32) with smoke and fire, with melt
  tracers, and with the adaptive domain, against JAX's fused frame (bf16
  features): > 40 dB;
- the smoke and fire sets of a frame: equal to the JAX package's (the
  opacity logit within 1e-6 of its largest);
- the port's own frame: the smoke and fire visibly present (> 10 pixels
  differ by > 0.05 from the frame without them), the fire adds energy,
  the melt tracers move the object between frames;
- ``build_clip_inputs`` with ``smoke_traj`` (4- and 5-tuple) and ``melt``:
  the JAX package's arrays;
- ``render_clip(smoke_cfg=...)``: the fused frames, one by one.

JAX's fused frames are read from its recording ``effects_clip``
(``tests/torch_references.py``); the inputs are built live.
"""
import os
import sys

import numpy as np
import jax.experimental.pallas as pl
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.ops import blend_pallas as JBP
from autovfx_tpu.ops import preprocess_pallas as PP
from autovfx_tpu.render import clip as JCL
from autovfx_tpu.render import smoke as JSMK
from autovfx_tpu_torch.core.cameras import index_camera
from autovfx_tpu_torch.ops.rasterize import rasterize, rasterize_multi
from autovfx_tpu_torch.render import clip as CL
from autovfx_tpu_torch.render import smoke as SMK

sys.path.insert(0, os.path.dirname(__file__))

import torch_references as REF  # noqa: E402
from test_clip_fused import _setup  # noqa: E402
from test_torch_clip import port_config, port_inputs, psnr  # noqa: E402

R = 12
FRAMES = 2
ORIGIN = np.array([-0.6, -0.6, -0.3], np.float32)
EXTENT = 1.2
FUSED_DB = 40.0
FUSED_CASES = [("smoke", 1), ("adaptive", 1), ("melt", 0)]


def smoke_cfgs():
    kw = dict(resolution=R, jacobi_iters=5, with_fire=True, dt=1.0 / 15.0)
    return SMK.SmokeConfig(**kw), JSMK.SmokeConfig(**kw)


def interpret(mp):
    orig = pl.pallas_call
    patched = lambda *a, **k: orig(*a, **dict(k, interpret=True))
    for mod in (pl, PP.pl, JBP.pl):
        mp.setattr(mod, "pallas_call", patched)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    interpret(monkeypatch)


def melt_tracers(inp):
    """Per-frame tracer positions drifting down and in, normals up."""
    s = inp.surf_points.shape[0]
    base = np.asarray(inp.surf_points) + np.array([0, 0, 0.3])
    pos = np.stack([base * (1.0 - 0.3 * f / max(FRAMES - 1, 1))
                    for f in range(FRAMES)]).astype(np.float32)
    nrm = np.tile(np.array([0, 0, 1.0], np.float32), (FRAMES, s, 1))
    return dict(pos=pos, norm=nrm, mask=np.ones(s, bool))


def clip_inputs():
    """JAX inputs (plain, smoke, adaptive smoke, melt), the JAX config,
    their ports and the port's config."""
    with pytest.MonkeyPatch.context() as mp:
        interpret(mp)
        inp, cfg = _setup(frames=FRAMES)
    _, jcfg = smoke_cfgs()
    mask = JSMK.sphere_inflow(jcfg, [6, 6, 2], 2.0)
    states = JSMK.simulate_smoke(jcfg, mask, FRAMES)
    a_states, cells = JSMK.simulate_smoke(jcfg, mask, FRAMES, adaptive=True)
    smoke = dict(
        smoke_density=states.density, smoke_temp=states.temperature,
        smoke_origin=jnp.asarray(ORIGIN), smoke_extent=jnp.float32(EXTENT),
        smoke_origin_cells=jnp.zeros((FRAMES, 3), jnp.int32))
    adaptive = dict(smoke, smoke_density=a_states.density,
                    smoke_temp=a_states.temperature, smoke_origin_cells=cells)
    m = melt_tracers(inp)
    melt = dict(melt_pos=jnp.asarray(m["pos"]),
                melt_norm=jnp.asarray(m["norm"]),
                melt_mask=jnp.asarray(m["mask"]))
    j = {"plain": inp, "smoke": inp._replace(**smoke),
         "adaptive": inp._replace(**adaptive), "melt": inp._replace(**melt)}
    return dict(jax=j, cfg=cfg, port={k: port_inputs(v) for k, v in j.items()},
                pcfg=port_config(cfg), states=states, adaptive=(a_states,
                                                                cells))


def fused_inputs_digest(clip) -> str:
    """The digest of the JAX fused frames' inputs (``FUSED_CASES``)."""
    return REF.digest(dict(inputs=clip["jax"], cfg=clip["cfg"],
                           smoke_cfg=smoke_cfgs()[1], cases=FUSED_CASES))


@pytest.fixture(scope="module")
def clip():
    return clip_inputs()


@pytest.fixture(scope="module")
def jax_fused(clip):
    """JAX's fused frames of ``FUSED_CASES`` (``shadow_scale=1``), from its
    recording ``effects_clip``."""
    return REF.load("effects_clip", fused_inputs_digest(clip))


@pytest.fixture(scope="module")
def port_frames(clip):
    """The port's fused frames 0 and 1 of each clip."""
    cfg, _ = smoke_cfgs()
    return {k: [CL.render_edited_frame_fused(inp, i, clip["pcfg"],
                                             shadow_scale=1, smoke_cfg=cfg)
                .numpy() for i in range(FRAMES)]
            for k, inp in clip["port"].items()}


@pytest.mark.parametrize("case, frame", FUSED_CASES)
def test_fused_frame_matches_jax_fused_frame(jax_fused, port_frames, case,
                                             frame):
    want = jax_fused[f"{case}_{frame}"]
    got = port_frames[case][frame]
    assert got.shape == want.shape
    assert psnr(got, want) > FUSED_DB, psnr(got, want)


@pytest.mark.parametrize("case", ["smoke", "adaptive"])
def test_smoke_sets_match_jax(clip, case):
    """The frame's smoke and fire sets: noise, adaptive offset and splats
    as the JAX fused frame computes them."""
    cfg, jcfg = smoke_cfgs()
    j, p = clip["jax"][case], clip["port"][case]
    f = 1
    cell = j.smoke_extent / j.smoke_density.shape[1]
    origin = j.smoke_origin + j.smoke_origin_cells[f].astype(jnp.float32) * cell
    want = JSMK.smoke_fire_gaussians(
        JSMK.apply_density_noise(j.smoke_density[f], f, jcfg),
        j.smoke_temp[f], origin, j.smoke_extent)
    got = CL.smoke_gaussians(p, f, cfg)
    for g, w in zip(got, want):
        for name in ("xyz", "sh_dc", "log_scales", "quats", "active"):
            assert np.array_equal(getattr(g, name).numpy(),
                                  np.asarray(getattr(w, name))), name
        a, b = g.opacity_logit.numpy(), np.asarray(w.opacity_logit)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    assert bool(got[0].active.any()) and bool(got[1].active.any())


def test_smoke_and_fire_visible_and_fire_adds_energy(port_frames):
    plain, fx = port_frames["plain"][1], port_frames["smoke"][1]
    assert np.isfinite(fx).all() and fx.min() >= 0.0 and fx.max() <= 1.0
    diff = np.abs(fx - plain).max(-1)
    assert (diff > 0.05).sum() > 10
    assert fx.sum() > plain.sum()


def test_fire_pass_is_added(clip, port_frames):
    """The effects frame is the composite of the merged render (with the
    smoke set) plus the fire set's own render at the fire budget."""
    from autovfx_tpu_torch.render import shadow as RSH

    cfg, _ = smoke_cfgs()
    inp, pcfg = clip["port"]["smoke"], clip["pcfg"]
    cam = index_camera(inp.cams, 1)
    g_smoke, g_fire = CL.smoke_gaussians(inp, 1, cfg)
    assert CL.fire_config(pcfg).dup_budget == min(pcfg.dup_budget, 1 << 18)
    fire = rasterize(g_fire, cam, config=CL.fire_config(pcfg))
    assert not bool(fire.overflow) and float(fire.alpha.max()) > 0.05
    out = rasterize_multi(
        [inp.bg, CL.shaded_object_gaussians(inp, 1, cam), g_smoke], cam,
        config=pcfg)
    alpha = out.alpha.clamp(0.0, 1.0)
    planes = CL.world_hull_planes_at(inp, 1)
    w_obj = RSH.hull_object_weight(cam, CL.pass_depth(out, alpha), planes,
                                   inp.hull_mask, pad=CL.object_pad(inp))
    ratio = RSH.shadow_ratio_map(cam, out.depth, alpha.clamp(min=1e-3),
                                 inp.light_dirs, inp.light_weights, planes,
                                 inp.hull_mask, scale=1)
    frame = CL.fused_composite(out, ratio, w_obj, fire.color)
    assert np.array_equal(frame.numpy(), port_frames["smoke"][1])
    assert float((frame - CL.fused_composite(out, ratio, w_obj)).sum()) > 0


def test_melt_tracers_move_the_object(port_frames):
    f0, f1 = port_frames["melt"]
    assert np.isfinite(f0).all() and np.isfinite(f1).all()
    assert np.abs(f0 - f1).max() > 0.05
    assert np.abs(f0 - port_frames["plain"][0]).max() > 0.05


def test_melt_override_matches_jax(clip):
    j, p = clip["jax"]["melt"], clip["port"]["melt"]
    from autovfx_tpu.core import cameras as JC

    want = JCL.shaded_object_gaussians(j, 1, JC.index_camera(j.cams, 1))
    got = CL.shaded_object_gaussians(p, 1, index_camera(p.cams, 1))
    for name in ("xyz", "sh_dc", "log_scales", "opacity_logit"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-12), name
    assert np.allclose(got.xyz.numpy(), j.melt_pos[1], atol=1e-6)


@pytest.mark.parametrize("adaptive", [False, True])
def test_build_clip_inputs_effects_match_jax(clip, adaptive):
    """The port's assembly from the same host inputs, with smoke_traj
    (4-tuple, or 5-tuple with the adaptive origins) and melt."""
    from autovfx_tpu_torch.render import smoke as SMK_

    inp = clip["jax"]["plain"]
    cfg, jcfg = smoke_cfgs()
    states = clip["adaptive"][0] if adaptive else clip["states"]
    hull = type("Hull", (), {"planes": np.asarray(inp.hull_planes),
                             "plane_mask": np.asarray(inp.hull_mask)})()
    surf = dict(points=np.asarray(inp.surf_points),
                normals=np.asarray(inp.surf_normals),
                colors=np.asarray(inp.surf_colors),
                radius=float(np.asarray(inp.surf_radius[0])))
    host = dict(objects=[{"scale": 1.0}], surfels=[surf],
                traj_pos=np.asarray(inp.traj_pos),
                traj_rot=np.asarray(inp.traj_rot), hull_shape=hull,
                env=np.asarray(inp.env), num_lights=4,
                melt=melt_tracers(inp))
    j_traj = (states, ORIGIN, EXTENT, jcfg)
    p_states = SMK_.SmokeState(*(torch.from_numpy(np.array(x))
                                 for x in states))
    p_traj = (p_states, ORIGIN, EXTENT, cfg)
    if adaptive:
        cells = np.asarray(clip["adaptive"][1])
        j_traj, p_traj = j_traj + (cells,), p_traj + (cells,)
    want = JCL.build_clip_inputs(bg=inp.bg, cams=inp.cams,
                                 smoke_traj=j_traj, **host)
    got = CL.build_clip_inputs(bg=clip["port"]["plain"].bg,
                               cams=clip["port"]["plain"].cams,
                               smoke_traj=p_traj, device="cpu", **host)
    for name in ("smoke_density", "smoke_temp", "smoke_origin",
                 "smoke_extent", "smoke_origin_cells", "melt_pos",
                 "melt_norm", "melt_mask", "surf_points", "light_dirs"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert got.smoke_origin_cells.dtype == torch.int32
    assert got.melt_mask.dtype == torch.bool


def test_render_clip_with_smoke_cfg(clip):
    cfg, _ = smoke_cfgs()
    p = clip["port"]["smoke"]
    frames = CL.render_clip(p, FRAMES, clip["pcfg"], fused=True,
                            smoke_cfg=cfg)
    assert frames.shape == (FRAMES, p.cams.height, p.cams.width, 3)
    for i in range(FRAMES):
        assert torch.equal(frames[i], CL.render_edited_frame_fused(
            p, i, clip["pcfg"], smoke_cfg=cfg))
