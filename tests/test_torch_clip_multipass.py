"""The port's multi-pass edited frame (two renders and the compositor)
against the JAX package's, on the CPU.

The clip is ``tests/test_torch_clip.py``'s, carried across from the JAX
package; the JAX frame renders through ``backend="ref"``.  The frames
are held by the share of pixels that agree, since the composite decides
by thresholds (the depth check, object alpha > 0, |ratio − 1| ≥ 0.01,
the slab test's 1e-4) that a last-bit difference can flip: ≥ 99.5 % of
pixels within 1e-4 and a mean difference ≤ 1e-3.
"""
import os
import sys

import numpy as np
import jax.experimental.pallas as pl
import pytest

from autovfx_tpu.ops import preprocess_pallas as PP
from autovfx_tpu.render import clip as JCL
from autovfx_tpu_torch.render import clip as CL

sys.path.insert(0, os.path.dirname(__file__))

from test_clip_fused import _setup  # noqa: E402
from test_torch_clip import port_config, port_inputs  # noqa: E402


@pytest.fixture(scope="module")
def clip():
    with pytest.MonkeyPatch.context() as mp:  # build_clip_inputs packs rows
        orig = pl.pallas_call
        mp.setattr(PP.pl, "pallas_call",
                   lambda *a, **k: orig(*a, **dict(k, interpret=True)))
        inp, cfg = _setup()
    return inp, cfg.replace(backend="ref"), port_inputs(inp), port_config(cfg)


@pytest.mark.parametrize("frame", [0, 1])
def test_multipass_frame_matches_jax(clip, frame):
    inp, cfg, pin, pcfg = clip
    want = np.asarray(JCL.render_edited_frame(inp, frame, cfg))
    got = CL.render_edited_frame(pin, frame, pcfg).numpy()
    assert got.shape == want.shape
    d = np.abs(got - want).max(axis=-1)
    assert (d <= 1e-4).mean() >= 0.995, (d <= 1e-4).mean()
    assert d.mean() <= 1e-3, d.mean()
