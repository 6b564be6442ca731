"""A collision fracture (``allow_fracture``) through the port's
``render_scene`` against the JAX package's (its recording
``edit_fracture``): dropped low enough to hit the ground faster than
0.7 m/s inside the 4 frames, the cube shatters at its first impact.
``tests/test_torch_edit.py``'s scene and bounds."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_edit import frames_close, rb_close, run_edit  # noqa: E402
from test_torch_edit import same_fragments  # noqa: E402

EDIT = dict(pos=[0.0, 0.0, 0.3], edits=["allow_fracture"])


@pytest.fixture(scope="module")
def fractured(tmp_path_factory):
    return run_edit(tmp_path_factory, "fracture", **EDIT)


def test_fracture_fragments_match_jax(fractured):
    want, ts, _, _ = fractured
    same_fragments(want["fragments"], ts)
    assert 1 <= ts._fragments["cube01"][0]["visible_from"] < 4


def test_fracture_rb_transform_matches_jax(fractured):
    want, ts, _, _ = fractured
    rb_close(ts.rb_transform, want["rb_transform"])


@pytest.mark.parametrize("frame", range(4))
def test_fracture_frames_match_jax(fractured, frame):
    _, _, want, got = fractured
    frames_close(got[frame], want[frame], f"frame {frame}")
