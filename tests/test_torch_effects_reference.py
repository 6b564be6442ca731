"""The effects frame of the port against the benchmark's plain reference
(``benchmark/reference/effects.py``) on the CPU: the port's own solves
and ``render_edited_frame_fused`` (through the ``effects-1m`` cell's
entry, at 128×96, 20,000 splats, 16³ adaptive smoke with fire, 6 frames,
a 16² melt of 4 substeps) against the reference's solves and frame, on
seeded random scenes; the reference's smoke and melt solves against
``simulate_smoke`` and ``MeltSim.run``; its noise and splats against
the port's, bit for bit."""
import math
import types
from typing import NamedTuple

import numpy as np
import pytest
import torch

from autovfx_tpu_torch.core.cameras import stack_cameras
from autovfx_tpu_torch.ops.rasterize import RasterConfig
from autovfx_tpu_torch.render import clip as CL
from autovfx_tpu_torch.render import liquid, smoke
from benchmark import harness, port, scene
from benchmark.reference import edit as ref_edit
from benchmark.reference import effects as ref_fx

FRAMES = 6
SEEDS = (2**31 + 21, 7)
PSNR_DB = 55.0  # the kernel budget of tests/test_golden.py
CONFIG = RasterConfig(dup_budget=1 << 18, tile=16)


def small_config() -> dict:
    cfg = dict(harness.resolve("effects-1m").config, splats=20_000,
               width=128, height=96, tile=16)
    cfg["edit"] = dict(cfg["edit"], surfels=2_000)
    cfg["ring"] = dict(cfg["ring"], views=FRAMES)
    fx = dict(cfg["effects"])
    fx["smoke"] = dict(fx["smoke"], resolution=16)
    # a wider inflow than 0.06 R, so that a 16³ plume holds many splats
    fx["domain"] = dict(fx["domain"], inflow_radius=0.15)
    fx["melt"] = dict(fx["melt"], resolution=16, substeps=4)
    cfg["effects"] = fx
    return cfg


class Clip(NamedTuple):
    cfg: dict
    scene: dict  # the benchmark's splat fields
    cams: list  # the reference's cameras
    s_cfg: smoke.SmokeConfig
    states: smoke.SmokeState  # the port's solves
    cells: torch.Tensor
    melt: liquid.MeltFrames
    inp: CL.ClipInputs  # the port's clip inputs
    ref_clip: ref_edit.Clip  # the reference's inputs and solve
    fx: ref_fx.Effects


@pytest.fixture(scope="module", params=SEEDS)
def clip(request):
    """The port's solves and clip inputs from the seeded inputs, as the
    ``effects-1m`` cell makes them, and the reference's own solve; the
    module's tests run on 4 CPU threads, and the worker's own count comes
    back after them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    seed, cfg = request.param, small_config()
    e, fxc = cfg["edit"], cfg["effects"]
    bg = scene.garden(cfg, seed, "cpu")
    views = scene.ring(cfg)
    surf = scene.cube_surfels(e, seed, "cpu")
    planes, mask = scene.cube_hull(e)
    pos, rot = ref_fx.rest_pose(e, FRAMES, seed)
    env = scene.envmap(e, seed)
    place = ref_fx.placement(fxc, pos, seed)
    mi = ref_fx.melt_inputs(surf, pos, rot, FRAMES)
    s_cfg = smoke.SmokeConfig(**fxc["smoke"])
    inflow = smoke.sphere_inflow(s_cfg, place.inflow_cell,
                                 place.inflow_radius, device="cpu")
    states, cells = smoke.simulate_smoke(s_cfg, inflow, FRAMES,
                                         adaptive=True)
    melt = liquid.MeltSim(mi.points, mi.normals, ground_z=e["ground_z"],
                          cfg=liquid.LiquidConfig(**fxc["melt"]),
                          device="cpu").run(mi.progress)
    inp = CL.build_clip_inputs(
        bg=port.gaussians(bg),
        cams=stack_cameras([port.camera(v, "cpu") for v in views]),
        objects=[{"scale": 1.0, "material": dict(e["material"])}],
        surfels=[surf], traj_pos=pos, traj_rot=rot,
        hull_shape=types.SimpleNamespace(planes=planes, plane_mask=mask),
        env=env, num_lights=e["lights"],
        smoke_traj=(states, place.origin, place.extent, s_cfg, cells),
        melt=dict(pos=melt.tracer_pos, norm=melt.tracer_norm,
                  mask=np.ones(len(mi.points), bool)), device="cpu")
    ref_clip = ref_edit.make_clip(surf, e["material"], pos, rot, planes,
                                  mask, env, e["lights"], "cpu")
    fx = ref_fx.solve(fxc, place, mi, e["ground_z"], FRAMES, "cpu")
    yield Clip(cfg, bg, port.ref_cams(views, "cpu"), s_cfg, states, cells,
               melt, inp, ref_clip, fx)
    torch.set_num_threads(threads)


def psnr(a, b) -> float:
    mse = float(torch.mean((a - b) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


def test_smoke_solve_matches_simulate_smoke(clip):
    fx, states = clip.fx, clip.states
    assert float(states.density.amax()) > 0.5
    torch.testing.assert_close(fx.density, states.density, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(fx.temperature, states.temperature,
                               atol=1e-5, rtol=0)
    assert torch.equal(fx.origin_cells, clip.cells)
    assert bool((clip.cells != 0).any())  # the domain moved


def test_melt_solve_matches_meltsim(clip):
    fx, mf = clip.fx, clip.melt
    torch.testing.assert_close(fx.melt_pos, mf.tracer_pos, atol=1e-5, rtol=0)
    torch.testing.assert_close(fx.melt_norm, mf.tracer_norm, atol=1e-5,
                               rtol=0)
    assert float(mf.tracer_fluid[-1].mean()) == 1.0  # all melted at the end
    moved = (fx.melt_pos[-1] - fx.melt_pos[0]).norm(dim=-1)
    assert float(moved.mean()) > 0.05


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frame_matches_the_reference(clip, frame):
    shadow = clip.cfg["edit"]["shadow_scale"]
    with torch.no_grad():
        got = CL.render_edited_frame_fused(clip.inp, frame, CONFIG, shadow,
                                           smoke_cfg=clip.s_cfg)
    want = ref_fx.frame(clip.scene, clip.ref_clip, clip.fx, frame,
                        clip.cams[frame], CONFIG.tile, shadow)
    assert psnr(got, want) > PSNR_DB


def test_the_effects_show_in_the_frame(clip):
    """Smoke, fire and melt each move the reference's frame well past the
    budget (so the comparison above is not of frames without them)."""
    fx, i = clip.fx, FRAMES - 2
    args = (i, clip.cams[i], CONFIG.tile, clip.cfg["edit"]["shadow_scale"])
    full = ref_fx.frame(clip.scene, clip.ref_clip, fx, *args)
    faint = fx._replace(density=torch.zeros_like(fx.density),
                        temperature=torch.zeros_like(fx.temperature))
    rigid = fx._replace(melt_pos=fx.melt_pos[:1].expand_as(fx.melt_pos),
                        melt_norm=fx.melt_norm[:1].expand_as(fx.melt_norm))
    cold = fx._replace(temperature=fx.temperature * 0.3)
    for other in (faint, rigid, cold):
        img = ref_fx.frame(clip.scene, clip.ref_clip, other, *args)
        assert psnr(full, img) < PSNR_DB - 10


def test_noise_is_bit_equal():
    g = torch.Generator().manual_seed(3)
    coords = (torch.rand((4000, 3), generator=g) - 0.3) * 300.0
    for period, seed in ((21.12, 17), (10.56, 18), (3.0, -5)):
        assert torch.equal(ref_fx.value_noise3(coords, period, seed),
                           smoke.value_noise3(coords, period, seed))
    s = smoke.SmokeConfig(resolution=12)
    d = torch.rand((12, 12, 12), generator=g)
    for f in (0, 7, 59):
        assert torch.equal(ref_fx.density_noise(d, f, s._asdict()),
                           smoke.apply_density_noise(d, f, s))


def test_splats_are_bit_equal(clip):
    i = 3
    got = CL.smoke_gaussians(clip.inp, i, clip.s_cfg)
    want = ref_fx.frame_splats(clip.fx, i)
    assert int(got[1].active.sum()) > 0  # the frame holds fire
    for g, w in zip(got, want):
        for name in ("xyz", "sh_dc", "sh_rest", "log_scales", "quats",
                     "opacity_logit", "active"):
            assert torch.equal(getattr(g, name), w[name]), name


def test_reference_imports_nothing_of_the_port():
    text = (harness.HERE / "reference" / "effects.py").read_text()
    assert "autovfx_tpu" not in text.replace("autovfx_tpu_torch", "")
    assert "import autovfx_tpu_torch" not in text
    assert "from autovfx_tpu_torch" not in text
