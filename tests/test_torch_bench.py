"""The port's bench (``python -m autovfx_tpu_torch.bench``) on the CPU, at
a small size, against the repo's ``bench.py`` (the JAX package's).

The small size: 2,000 splats, 64×48, 2 ring views, tile 16, smoke 16³,
the SuGaR grid 24 and 2,000 vertices (``bench.py``'s knobs), with the
cube's surfels cut from 50,000 to 1,000, one pass for each rate and,
where the SuGaR stage runs, the scene's extent from 2.67 to 0.3 m (at
2,000 splats over the Garden's extent the density field nowhere reaches
the level, so the level set is empty; the bench's 1M splats cross it):
``Settings`` fields that no environment variable sets.  Each stage sizes
its own duplicate budget, the edited frames from their merged sets.

- Each mode runs on ``device="cpu"``; its last line holds exactly
  ``bench.py``'s keys for that mode, every number finite and positive,
  and each line before it is a checkpoint of the same run.  The edited
  frames' budget covers the merged render, which bench.py's
  background-only rule does not at 64×48.
- The set-up matches ``bench.py``'s own: the ring cameras within 1e-6,
  the envmap bit for bit, the cube drop's trajectory against the JAX
  package's ``simulate`` within ``tests/test_physics_golden.py``'s drop
  bounds, the smoke's config and inflow mask exactly.
- On the bench's inputs (built the JAX way and carried across with
  ``convert``; and built by the port's bench from the same scene), the
  first edited frame is within ``tests/test_torch_clip.py``'s > 40 dB of
  the JAX package's ``render_edited_frame_fused`` (its Pallas kernels in
  interpret mode).
- ``rms_to_levelset`` is within 1e-5 of ``bench.py:605-613``'s formula
  on the same vertices and scene.
- With ``jax``, ``jaxlib``, ``flax`` and ``autovfx_tpu`` blocked, the
  bench imports and runs its ``view`` mode; a failing stage and a
  missing card end the run with one error line and a non-zero exit.
"""
import dataclasses
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.core.gaussians import Gaussians as JGaussians
from autovfx_tpu.core.quaternion import quat_to_rotmat
from autovfx_tpu.ops import blend_pallas as JBP
from autovfx_tpu.ops import preprocess_pallas as PP
from autovfx_tpu.ops.rasterize import RasterConfig as JRasterConfig
from autovfx_tpu.physics import world as JW
from autovfx_tpu.render import clip as JCL
from autovfx_tpu.render import meshsplat as JMS
from autovfx_tpu.render import smoke as JSMK
from autovfx_tpu.sugar import density as JD
from autovfx_tpu.sugar.levelset import _nearest_gaussian as j_nearest
from autovfx_tpu.utils.synthetic import make_garden_like as j_garden_like
from autovfx_tpu_torch import bench, convert
from autovfx_tpu_torch.core.cameras import stack_cameras
from autovfx_tpu_torch.ops import binning
from autovfx_tpu_torch.physics import world as W
from autovfx_tpu_torch.render import clip as CL
from autovfx_tpu_torch.sugar import extract_mesh as EX
from autovfx_tpu_torch.utils.synthetic import make_garden_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(BENCH_GAUSSIANS="2000", BENCH_WIDTH="64", BENCH_HEIGHT="48",
           BENCH_FRAMES="2", BENCH_TILE="16", BENCH_SMOKE_RES="16",
           BENCH_SUGAR_RES="24", BENCH_SUGAR_VERTS="2000")
SURFELS = 1000
SUGAR_EXTENT = 0.3  # m: a scene dense enough to cross the level
FRAME_BUDGET = 16384  # the JAX frame's (its chunk padding needs room)
FRAME_PSNR_DB = 40.0  # tests/test_torch_clip.py:157-162
HEAD = {"metric", "value", "unit", "vs_baseline"}
# bench.py's keys for each mode (its _emit calls)
EDIT = {"dup_budget", "physics_steps_per_sec", "edit_effects_fps",
        "smoke_res"}
KEYS = {
    "view": HEAD | {"dup_budget", "novel_view_fps"},
    "edit": HEAD | EDIT,
    "all": HEAD | EDIT | {"novel_view_fps", "edit_replay_fps",
                          "edit_replay_wall_s", "train_iters_per_sec",
                          "sugar_extract_seconds", "sugar_vertices",
                          "sugar_rms_to_levelset"},
    "train": HEAD,
    "sugar": HEAD | {"rms_to_levelset", "vertices", "faces"},
}
UNITS = {"train": "iters/s", "sugar": "seconds"}


def small(mode: str = "all", **kw) -> bench.Settings:
    kw = {"surfels": SURFELS, "window_s": 0.0, **kw}
    return dataclasses.replace(
        bench.Settings.from_env(dict(ENV, BENCH_MODE=mode)), **kw)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain path on one thread (beside the suite's other workers,
    torch's intra-op threads oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_bench():
    """The repo's bench.py at the small size, imported under a name of its
    own; the two JAX cache settings its import makes are restored, so no
    other test of this worker inherits them."""
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in names}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        spec = importlib.util.spec_from_file_location(
            "jax_bench", os.path.join(REPO, "bench.py"))
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
    return mod


@pytest.mark.parametrize("mode", bench.MODES)
def test_mode_prints_bench_keys(mode, capsys):
    s = small(mode, **({"extent": SUGAR_EXTENT}
                       if mode in ("all", "sugar") else {}))
    line = bench.run(s, "cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[-1] == line
    assert set(line) == KEYS[mode], set(line) ^ KEYS[mode]
    assert line["unit"] == UNITS.get(mode, "frames/s")
    for k, v in line.items():
        if k not in ("metric", "unit"):
            assert math.isfinite(v) and v > 0, (k, v)
    # each earlier line is a checkpoint: a subset of the last one's keys
    for earlier in lines[:-1]:
        assert set(earlier) <= set(line) and "error" not in earlier
    if mode == "all":
        assert line["sugar_vertices"] <= int(ENV["BENCH_SUGAR_VERTS"])
        assert line["smoke_res"] == int(ENV["BENCH_SMOKE_RES"])
        g = make_garden_like(s.gaussians, seed=0, extent=s.extent,
                             device="cpu")
        cams = bench.ring_cameras(s.width, s.height, s.frames, "cpu")
        assert line["dup_budget"] == bench.auto_budget(g, cams, s.tile)


def test_settings_read_bench_names_and_defaults():
    """bench.py's names and defaults; its knobs for the TPU and its
    tunnel are not read, nor are the bench's own fields."""
    s = bench.Settings.from_env({})
    assert (s.mode, s.gaussians, s.width, s.height, s.tile, s.frames,
            s.dup_budget, s.smoke_res, s.shadow_scale, s.sugar_res,
            s.sugar_verts) == ("all", 1_000_000, 1296, 840, 32, 8, None, 96,
                               2, 160, 200_000)
    assert (s.surfels, s.extent, s.window_s) == (50_000, 2.67, 2.0)
    assert s == bench.Settings()
    got = bench.Settings.from_env(dict(ENV, BENCH_DUP_BUDGET="4096",
                                       BENCH_SHADOW_SCALE="1"))
    assert (got.gaussians, got.width, got.height, got.frames, got.tile,
            got.dup_budget, got.smoke_res, got.shadow_scale, got.sugar_res,
            got.sugar_verts) == (2000, 64, 48, 2, 16, 4096, 16, 1, 24, 2000)
    ignored = {k: "0" for k in (
        "BENCH_EDIT_FUSED", "BENCH_EDIT_EFFECTS", "BENCH_REPLAY",
        "BENCH_ALL_EXTENDED", "BENCH_CHUNK", "BENCH_FEATURE_PACK",
        "BENCH_SKIP_PROBE", "BENCH_DISPATCH_PACE", "AUTOVFX_PAD_MODE",
        "BENCH_SURFELS", "BENCH_EXTENT", "BENCH_WINDOW_S")}
    assert bench.Settings.from_env(ignored) == bench.Settings()
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.Settings.from_env({"BENCH_MODE": "fast"})


def test_edit_budgets_cover_the_merged_renders():
    """At 64×48, bench.py's background-only budget is smaller than the
    edited frame's merged render needs; ``merged_budget`` covers the
    background, the object and the smoke splats of every ring view (at
    the bench's 50,000 surfels)."""
    s = small("edit", surfels=bench.Settings.surfels)
    g = make_garden_like(s.gaussians, seed=0, extent=s.extent, device="cpu")
    cams = bench.ring_cameras(s.width, s.height, s.frames, "cpu")
    w, corners = bench.cube_world(device="cpu")
    _, pos, quat = W.simulate(w, s.frames)
    traj = W.origin_trajectory(w, pos, quat)
    surf = bench.cube_surfels(corners, s.surfels, "cpu")
    inp = bench.clip_inputs(g, cams, w, surf, traj, "cpu")
    inp_fx, s_cfg = bench.effects_inputs(g, cams, w, surf, traj, s, "cpu")
    cfg = bench.RasterConfig(tile=s.tile)

    def need(sets, cam):
        return int(binning.required_budget(
            bench.preprocess_sets(sets, cam, cfg)))

    worst = max(need([g, CL.shaded_object_gaussians(inp, i, cam)], cam)
                for i, cam in enumerate(cams))
    worst_fx = max(need([g, CL.shaded_object_gaussians(inp_fx, i, cam),
                         CL.smoke_gaussians(inp_fx, i, s_cfg)[0]], cam)
                   for i, cam in enumerate(cams))
    assert bench.auto_budget(g, cams, s.tile) < worst
    assert bench.merged_budget(inp, cams, s.tile) >= worst
    assert bench.merged_budget(inp_fx, cams, s.tile, s_cfg) >= worst_fx


def test_ring_cameras_match_bench_py(jax_bench):
    want = jax_bench._make_cams()
    got = stack_cameras(bench.ring_cameras(64, 48, 2, device="cpu"))
    assert (got.width, got.height) == (want.width, want.height)
    for f in convert.CAMERA_FIELDS:
        if f in ("width", "height"):
            continue
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f)


def test_envmap_matches_bench_py():
    """bench.py:380-381 makes the envmap inline; its expression is held
    here and pinned to the file's text."""
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    assert "rng = np.random.RandomState(0)" in src
    assert "env = (0.4 + 0.6 * rng.rand(32, 64, 3)).astype(np.float32)" in src
    rng = np.random.RandomState(0)
    want = (0.4 + 0.6 * rng.rand(32, 64, 3)).astype(np.float32)
    got = bench.envmap()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def drop(jax_bench):
    jw, j_corners = jax_bench._cube_world(jax_bench.FRAMES)
    pw, corners = bench.cube_world(device="cpu")
    assert np.array_equal(corners, j_corners)
    return jw, pw, JW.simulate(jw, jax_bench.FRAMES)


def test_cube_drop_matches_jax(drop):
    """tests/test_physics_golden.py:98-105's drop bounds: the whole
    trajectory within 0.15 m, the last five frames within 0.01 m."""
    _, pw, (_, jpos, _) = drop
    _, pos, _ = W.simulate(pw, len(jpos))
    assert pos.shape == jpos.shape
    assert np.abs(pos - jpos).max() < 0.15
    assert np.abs(pos[-5:] - jpos[-5:]).max() < 0.01


def test_smoke_config_and_inflow_match_bench_py():
    """bench.py:430-437."""
    r = int(ENV["BENCH_SMOKE_RES"])
    want_cfg = JSMK.SmokeConfig(resolution=r, dt=1.0 / 15.0, with_fire=True,
                                dissolve_speed=30)
    cfg = bench.smoke_config(r)
    assert cfg._asdict() == want_cfg._asdict()
    want = JSMK.sphere_inflow(want_cfg, [r // 2, r // 2, r // 6],
                              0.06 * want_cfg.resolution)
    got = bench.smoke_inflow(cfg, device="cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(PP.pl, "pallas_call", patched)
    monkeypatch.setattr(JBP.pl, "pallas_call", patched)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return -10.0 * np.log10(max(mse, 1e-30))


def test_first_edited_frame_matches_jax(jax_bench, drop, interpret_pallas):
    """bench.py:355-392's inputs built the JAX way (its scene, ring, drop,
    surfels, envmap and 16 lights), carried across with ``convert``; the
    port's headline frame against JAX's fused frame.  The port's bench
    builds its own inputs from the same scene: the same budget."""
    jb = jax_bench
    jw, pw, (_, pos, quat) = drop
    g = j_garden_like(jb.N_GAUSS, extent=2.67)
    cams = jb._make_cams()
    rots = np.asarray(quat_to_rotmat(jnp.asarray(quat.reshape(-1, 4))))
    rots = rots.reshape(jb.FRAMES, -1, 3, 3)
    origin = pos - np.einsum("fbij,bj->fbi", rots, jw.com_offsets)
    surf = JMS.sample_mesh_surfels(jb._cube_world(jb.FRAMES)[1],
                                   bench.CUBE_FACES, num_samples=SURFELS)
    inp = JCL.build_clip_inputs(
        bg=g, cams=cams, objects=[bench.CUBE_OBJECT], surfels=[surf],
        traj_pos=origin.astype(np.float32), traj_rot=rots.astype(np.float32),
        hull_shape=jw.shape, env=bench.envmap(),
        num_lights=bench.EDIT_LIGHTS, pack_rows=True)
    budget = FRAME_BUDGET
    cfg = JRasterConfig(dup_budget=budget, backend="pallas",
                        feature_pack="bf16", tile=jb.TILE, chunk=jb.CHUNK)
    want = np.asarray(JCL.render_edited_frame_fused(inp, 0, cfg,
                                                    shadow_scale=2))

    pg = convert.gaussians({f: np.asarray(getattr(g, f))
                            for f in convert.GAUSSIAN_FIELDS}, device="cpu")
    pcams = convert.camera(
        {f: np.asarray(getattr(cams, f)) if f not in ("width", "height")
         else getattr(cams, f) for f in convert.CAMERA_FIELDS}, device="cpu")
    arrays = {name: np.asarray(getattr(inp, name)) for name in inp._fields
              if name not in ("bg", "cams", "bg_rows")
              and getattr(inp, name) is not None}
    pin = convert.clip_inputs(arrays, pg, pcams, device="cpu")
    s = small("edit")
    pcfg = bench.RasterConfig(dup_budget=budget, tile=s.tile)
    frame = functools.partial(CL.render_edited_frame_fused,
                              shadow_scale=s.shadow_scale)
    got = frame(pin, 0, pcfg).numpy()
    assert got.shape == want.shape
    assert _psnr(got, want) > FRAME_PSNR_DB

    # the port's bench's own inputs from the same scene and its own drop
    cams_list = bench.ring_cameras(s.width, s.height, s.frames, "cpu")
    _, ppos, pquat = W.simulate(pw, s.frames)
    own = bench.clip_inputs(pg, cams_list, pw,
                            bench.cube_surfels(bench.cube_corners(), s.surfels,
                                               "cpu"),
                            W.origin_trajectory(pw, ppos, pquat), "cpu")
    assert _psnr(frame(own, 0, pcfg).numpy(), want) > FRAME_PSNR_DB


def test_rms_to_levelset_matches_bench_py_formula():
    """bench.py:602-613 on the JAX side, on the port's scene and mesh."""
    s = small("sugar", extent=SUGAR_EXTENT)
    g = make_garden_like(s.gaussians, seed=0, extent=s.extent, device="cpu")
    cams = bench.ring_cameras(s.width, s.height, s.frames, "cpu")
    mesh = EX.extract_mesh_from_gaussians(
        g, stack_cameras(cams), config=bench.RasterConfig(
            dup_budget=bench.auto_budget(g, cams, s.tile), tile=s.tile),
        fg_resolution=s.sugar_res, bg_resolution=bench.SUGAR_BG_RES,
        target_vertices=s.sugar_verts)
    got = bench.rms_to_levelset(g, mesh.vertices)

    jg = JGaussians(**{f: jnp.asarray(getattr(g, f).numpy())
                       for f in convert.GAUSSIAN_FIELDS})
    v = np.asarray(mesh.vertices, np.float32)
    sel = jnp.asarray(v[:: max(len(v) // 20_000, 1)])
    g_neighbors = JD.reset_neighbors(jg, k=16)
    nearest, _ = j_nearest(sel, jg)
    dens = np.asarray(JD.compute_density(sel, g_neighbors[nearest], jg))
    want = float(np.sqrt(np.mean((np.clip(dens, 0, 1) - 0.3) ** 2)))
    assert 0.0 < got and abs(got - want) <= 1e-5, (got, want)


BLOCKED_VIEW = """
import os, sys
for m in ("jax", "jaxlib", "flax", "autovfx_tpu"):
    sys.modules[m] = None  # any import of them now raises
os.environ.update({env})
import torch
torch.set_num_threads(1)
from autovfx_tpu_torch import bench
line = bench.main(["--device", "cpu"])
assert "novel_view_fps" in line and line["novel_view_fps"] > 0
print("OK")
"""


def test_imports_and_runs_view_without_jax():
    env = dict(ENV, BENCH_MODE="view")
    r = subprocess.run([sys.executable, "-c",
                        BLOCKED_VIEW.format(env=repr(env))], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_a_failing_stage_prints_one_error_line_and_raises(capsys,
                                                          monkeypatch):
    """No stage falls back: the run ends with the error line."""
    def fail(*a, **k):
        raise RuntimeError("the stage broke")

    monkeypatch.setattr(bench, "novel_view_fps", fail)
    for k, v in dict(ENV, BENCH_MODE="view").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="the stage broke"):
        bench.main(["--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["error"] == "RuntimeError: the stage broke"


def test_an_overflowing_render_fails_the_run(capsys):
    with pytest.raises(RuntimeError, match="overflowed"):
        bench.run(dataclasses.replace(small("view"), dup_budget=64), "cpu")
