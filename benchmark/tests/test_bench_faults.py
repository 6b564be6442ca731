"""A whole run on the CPU at a small size, past the harness's look for a
card: sound, it is correct; with the timed path broken underneath, or
with the control (the reference in bfloat16) in the program's place, it
is not."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import run_tiny, tiny_cell

FRAMES = ("view-3m", "edit-1m")
STEPS = ("train-3m", "sugar-coarse-1m")


@pytest.mark.parametrize("name", harness.cell_names())
def test_sound_run_is_correct(name):
    r = run_tiny(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", harness.cell_names())
def test_traced_run_is_correct(name):
    r = run_tiny(name, trace=True)
    assert r["correct"], r["checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", FRAMES)
def test_a_frame_altered_where_it_is_produced_fails(monkeypatch, name):
    from autovfx_tpu_torch.ops import blend_cuda

    real = blend_cuda.blend

    def altered(*a, **k):
        color, depth, alpha = real(*a, **k)
        color = color.clone()
        color[:16, :16] += 0.05  # one tile's answer
        return color, depth, alpha

    monkeypatch.setattr(blend_cuda, "blend", altered)
    r = run_tiny(name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", STEPS)
def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch, name):
    from autovfx_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "apply_adam", lambda g, adam, *a, **k: (
        g, dataclasses.replace(adam, count=adam.count + 1)))
    r = run_tiny(name)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", STEPS)
def test_a_loss_over_half_the_batch_fails(monkeypatch, name):
    from autovfx_tpu_torch.train import losses

    monkeypatch.setattr(losses, "photometric_loss", losses.photometric_loss)
    control.half_loss()
    r = run_tiny(name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", harness.cell_names())
def test_the_control_fails(name):
    r = control.readings(tiny_cell(name), 2**31 + 3, 0.2, True,
                         torch.device("cpu"), lambda: None)
    lim = tiny_cell(name).traffic["limits"]
    assert all(v <= lim[k] for k, v in r["program"].items())
    assert any(v > lim[k] for k, v in r["control"].items()), r
