"""An effects edit through the port's ``render_scene`` against the JAX
package's: one cube on fire (``add_fire``: the smoke and fire volume,
the burn to black) and melting (``make_melting``: the liquid's tracers
and the hull refit to them).  ``tests/test_torch_edit.py``'s scene over its first
2 frames, and its frame bounds.

The scene puts a single emitter at the smoke domain's center cell (24
of 48 in x and y), where the adaptive domain's recentering shift rounds
a plume centroid of 24 - 23.5 = 0.5: an exact tie that the order of a
float sum decides (``tests/test_torch_smoke.py`` holds the solver to
JAX's off such ties).  So the port's own trajectory is held to JAX's
within that one-cell decision, and the frames are rendered by the port
from JAX's trajectory: the smoke splats, their noise, the fire and the
composite against JAX's on the same volume.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_edit import frames_close, run_edit  # noqa: E402


def port_smoke_traj(jax_traj):
    """JAX's (states, origin, extent, config, origin cells) as the
    port's, on the CPU."""
    from autovfx_tpu_torch.render import smoke as SM

    states, origin, extent, cfg, cells = jax_traj
    t = lambda x: torch.tensor(np.asarray(x))
    return (SM.SmokeState(*(t(x) for x in states)), origin, extent,
            SM.SmokeConfig(**cfg._asdict()), t(cells))


@pytest.fixture(scope="module")
def burning(tmp_path_factory):
    own = {}

    def fire(js, ts):
        from autovfx_tpu.edit import edit_utils as JEU
        from autovfx_tpu_torch.edit import edit_utils as EU

        JEU.add_fire(js, js.inserted_objects[0])
        EU.add_fire(ts, ts.inserted_objects[0])
        own["port"] = ts._smoke_trajectory()
        own["jax"] = js._smoke_trajectory()
        ts._smoke_traj = port_smoke_traj(own["jax"])

    out = run_edit(tmp_path_factory, "effects", [0.0, 0.0, 0.15],
                   ["make_melting"], after=fire, n_cams=2)
    return out + (own,)


def test_effects_edit_state(burning):
    js, ts, _, _, _ = burning
    assert ts.fire_objects == js.fire_objects == ["cube01"]
    assert "cube01" in ts._melt_sims
    got, want = ts._melt_sims["cube01"][1], js._melt_sims["cube01"][1]
    for f in ("h", "eta", "tracer_pos", "tracer_fluid", "volume"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-4, err_msg=f)


def test_effects_smoke_domain_matches_jax_up_to_the_centroid_tie(burning):
    own = burning[-1]
    states, origin, extent, cfg, cells = own["port"]
    j_states, j_origin, j_extent, j_cfg, j_cells = own["jax"]
    np.testing.assert_array_equal(origin, j_origin)
    assert extent == j_extent and cfg._asdict() == j_cfg._asdict()
    d = np.abs(cells.numpy() - np.asarray(j_cells))
    assert d[:, :2].max() <= 1 and d[:, 2].max() == 0, (cells, j_cells)
    assert torch.isfinite(states.density).all()
    np.testing.assert_allclose(states.density[0].sum().item(),
                               float(np.asarray(j_states.density[0]).sum()),
                               rtol=1e-4)


@pytest.mark.parametrize("frame", range(2))
def test_effects_frames_match_jax(burning, frame):
    _, _, want, got, _ = burning
    assert torch.isfinite(got[frame]).all()
    frames_close(got[frame], want[frame], f"frame {frame}")
