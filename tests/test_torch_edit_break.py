"""A break edit (``make_break``) through the port's ``render_scene``
against the JAX package's: the cube shatters at the clip's middle into 8
fragments that fall on their own.  ``tests/test_torch_edit.py``'s scene
and bounds."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_edit import frames_close, rb_close, run_edit  # noqa: E402
from test_torch_edit import same_fragments  # noqa: E402


@pytest.fixture(scope="module")
def broken(tmp_path_factory):
    return run_edit(tmp_path_factory, "break", [0.0, 0.0, 1.2],
                    ["make_break"])


def test_break_fragments_match_jax(broken):
    js, ts, _, _ = broken
    same_fragments(js, ts)
    assert ts._fragments["cube01"][0]["visible_from"] == 2


def test_break_rb_transform_matches_jax(broken):
    js, ts, _, _ = broken
    rb_close(ts.rb_transform, js.rb_transform)
    assert len(ts.rb_transform) == 9  # the cube and its 8 fragments


@pytest.mark.parametrize("frame", range(4))
def test_break_frames_match_jax(broken, frame):
    _, _, want, got = broken
    assert torch.isfinite(got[frame]).all()
    frames_close(got[frame], want[frame], f"frame {frame}")
