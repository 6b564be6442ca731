"""The effects cell on the CPU at a small size (3,000 splats, 96×64, tile
16, 500 surfels, 6 frames, 16³ smoke with a 0.15 R inflow, a 16² melt of
4 substeps): sound, it is correct; with each effect broken where the
program makes it, its effects check fails, and with the control (the
reference in bfloat16) in the program's place, the check fails.  ``FAULTS`` plants each fault with a
``pytest.MonkeyPatch``, so a script can read their checks at full size."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import TINY

SEED = 2**31 + 11


def small_cell() -> harness.Cell:
    cell = harness.resolve("effects-1m")
    cfg = dict(cell.config, **TINY)
    cfg["edit"] = dict(cfg["edit"], surfels=500)
    cfg["ring"] = dict(cfg["ring"], views=6)
    fx = dict(cfg["effects"])
    fx["smoke"] = dict(fx["smoke"], resolution=16)
    fx["domain"] = dict(fx["domain"], inflow_radius=0.15)
    fx["melt"] = dict(fx["melt"], resolution=16, substeps=4)
    cfg["effects"] = fx
    return cell._replace(config=cfg)


def no_smoke_in_merged(mp) -> None:
    """The smoke set left out of the merged render."""
    from autovfx_tpu_torch.render import clip

    real = clip.rasterize_multi
    mp.setattr(clip, "rasterize_multi",
               lambda sets, *a, **k: real(sets[:2], *a, **k))


def no_fire_pass(mp) -> None:
    """The fire render skipped: nothing is added."""
    from autovfx_tpu_torch.render import clip

    real = clip.rasterize

    def dark(*a, **k):
        out = real(*a, **k)
        return out._replace(color=torch.zeros_like(out.color))

    mp.setattr(clip, "rasterize", dark)


def rigid_cube(mp) -> None:
    """The melt's tracers ignored: the cube keeps its rest pose."""
    from autovfx_tpu_torch.render import clip

    real = clip.build_clip_inputs
    mp.setattr(clip, "build_clip_inputs",
               lambda *a, melt=None, **k: real(*a, **k))


def half_inflow(mp) -> None:
    """The smoke solved with half the inflow density."""
    from autovfx_tpu_torch.render import smoke

    real = smoke.simulate_smoke
    mp.setattr(smoke, "simulate_smoke", lambda cfg, *a, **k: real(
        cfg._replace(inflow_density=cfg.inflow_density / 2), *a, **k))


def no_noise(mp) -> None:
    """The display noise off."""
    from autovfx_tpu_torch.render import smoke

    mp.setattr(smoke, "apply_density_noise", lambda d, *a, **k: d)


FAULTS = {f.__name__: f for f in (no_smoke_in_merged, no_fire_pass,
                                  rigid_cube, half_inflow, no_noise)}


def one_pass(cell: harness.Cell, seed: int = SEED) -> list:
    """The check after one pass of the clip (each frame once, so the
    sample holds two distinct frames whatever the machine's pace)."""
    torch.set_num_threads(4)
    sess = cell.entry.setup(harness.Context(cell.config, cell.traffic, seed,
                                            torch.device("cpu")))
    for i in range(sess.period):
        sess.seen(i, sess.call(i))
    sess.release()
    return sess.finish(False).checks


def run_small(trace: bool = False) -> dict:
    torch.set_num_threads(4)
    return harness.run(small_cell(), SEED, 1.0, trace, torch.device("cpu"),
                       time.perf_counter(), log=lambda s: None)


def test_sound_pass_is_correct():
    checks = one_pass(small_cell())
    assert all(c.ok for c in checks), checks


def test_sound_run_is_correct():
    r = run_small()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_traced_run_counts_both_renders():
    r = run_small(trace=True)
    assert r["correct"], r["checks"]
    for name in ("smoke_ms.frames", "fire_ms.frames", "smoke_fill.frames"):
        assert r["metrics"][name]["value"] > 0, name


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_effect_fails(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    checks = {c.name: c for c in one_pass(small_cell())}
    # the effects check alone sees each: at full size the clutter hides
    # the cube and the merged smoke from frame_rmse
    assert not checks["effects_rmse"].ok, checks


def test_the_control_fails():
    cell = small_cell()
    r = control.readings(cell, SEED, 1.0, True, torch.device("cpu"),
                         lambda: None)
    lim = cell.traffic["limits"]
    assert all(v <= lim[k] for k, v in r["program"].items())
    assert any(v > lim[k] for k, v in r["control"].items()), r
