"""The edited frame of the PyTorch port against the JAX package, on the CPU.

One small clip (``tests/test_clip_fused.py``'s ``_setup``: a 400-splat
ground carpet, a 3,000-surfel cube falling through two frames, 96×64,
tile 16, an 8-light seeded envmap) is built by the JAX package and
carried across with ``convert``, so both sides render the same inputs.
The JAX fused frame runs its Pallas kernels in interpret mode, as that
file does.  Budgets:

- ``rasterize_multi([bg, obj])`` against JAX ``rasterize(backend="ref")``
  of the concatenated set: > 70 dB color, alpha and depth as
  ``tests/test_golden.py:112-122``;
- the port's fused frame (exact float32) against JAX's fused frame
  (bf16 features): > 40 dB;
- the port's fused frame against its own multi-pass frame: the bounds of
  ``tests/test_clip_fused.py:93-106``;
- ``render_clip`` of two frames, plain and 2× supersampled: shape,
  finite, within [0, 1]; malformed effects inputs raise.

JAX's frames are read from its recording ``clip``
(``tests/torch_references.py``); the inputs are built live.

The multi-pass frame against JAX's is ``tests/test_torch_clip_multipass.py``;
the frame with smoke, fire and melt tracers is
``tests/test_torch_effects_clip.py``.
"""
import os
import sys

import numpy as np
import jax.experimental.pallas as pl
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.ops import blend_pallas as JBP
from autovfx_tpu.ops import preprocess_pallas as PP
from autovfx_tpu.render import clip as JCL
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.core.cameras import index_camera
from autovfx_tpu_torch.ops.rasterize import (RasterConfig, rasterize,
                                             rasterize_multi)
from autovfx_tpu_torch.render import clip as CL

sys.path.insert(0, os.path.dirname(__file__))

import torch_references as REF  # noqa: E402
from test_clip_fused import _setup  # noqa: E402


def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(PP.pl, "pallas_call", patched)
    monkeypatch.setattr(JBP.pl, "pallas_call", patched)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    interpret(monkeypatch)


def port_gaussians(g):
    return convert.gaussians(
        {f: np.asarray(getattr(g, f)) for f in convert.GAUSSIAN_FIELDS},
        device="cpu")


def port_cameras(cams):
    return convert.camera(
        {f: np.asarray(getattr(cams, f)) if f not in ("width", "height")
         else getattr(cams, f) for f in convert.CAMERA_FIELDS}, device="cpu")


def port_inputs(inp):
    """The port's ClipInputs carried over from the JAX package's."""
    arrays = {name: np.asarray(getattr(inp, name))
              for name in inp._fields
              if name not in ("bg", "cams", "bg_rows")
              and getattr(inp, name) is not None}
    return convert.clip_inputs(arrays, port_gaussians(inp.bg),
                               port_cameras(inp.cams), device="cpu")


def port_config(cfg):
    return RasterConfig(dup_budget=cfg.dup_budget, tile=cfg.tile)


def clip_setup():
    """``_setup``'s JAX inputs and config."""
    with pytest.MonkeyPatch.context() as mp:  # build_clip_inputs packs rows
        orig = pl.pallas_call
        mp.setattr(PP.pl, "pallas_call",
                   lambda *a, **k: orig(*a, **dict(k, interpret=True)))
        return _setup()


def jax_inputs_digest(inp, cfg) -> str:
    return REF.digest(dict(inputs=inp, cfg=cfg))


@pytest.fixture(scope="module")
def clip():
    """(JAX inputs, JAX config, port inputs, port config)."""
    inp, cfg = clip_setup()
    return inp, cfg, port_inputs(inp), port_config(cfg)


@pytest.fixture(scope="module")
def jax_frame(clip):
    """Frame 0 of JAX's clip, from its recording ``clip``: ``rasterize``
    (``backend="ref"``) of the background and object sets joined, and
    the fused frame at ``shadow_scale=2``."""
    inp, cfg, _, _ = clip
    return REF.load("clip", jax_inputs_digest(inp, cfg))


@pytest.fixture(scope="module")
def port_fused(clip):
    _, _, pin, pcfg = clip
    return CL.render_edited_frame_fused(pin, 0, pcfg, shadow_scale=2).numpy()


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return -10.0 * np.log10(max(mse, 1e-30))


def test_rasterize_multi_matches_jax_ref_of_the_concatenated_set(
        clip, jax_frame):
    _, _, pin, pcfg = clip
    want = jax_frame["merged_ref"]
    cam = index_camera(pin.cams, 0)
    got = rasterize_multi(
        [pin.bg, CL.shaded_object_gaussians(pin, 0, cam)], cam, config=pcfg)
    assert not bool(got.overflow)
    assert psnr(got.color.numpy(), want["color"]) > 70.0
    assert np.abs(got.alpha.numpy() - np.asarray(want["alpha"])).max() < 1e-5
    wd = np.asarray(want["depth"])
    rel = np.abs(got.depth.numpy() - wd) / np.maximum(wd, 1e-3)
    assert rel.max() < 1e-4


def test_rasterize_multi_is_rasterize_of_the_merged_set(clip):
    """The joined splats are the concatenated set's, row for row, so the
    two renders agree to the last bit."""
    _, _, pin, pcfg = clip
    from autovfx_tpu_torch.core.gaussians import merge

    cam = index_camera(pin.cams, 1)
    g_obj = CL.shaded_object_gaussians(pin, 1, cam)
    a = rasterize_multi([pin.bg, g_obj], cam, config=pcfg)
    b = rasterize(merge(pin.bg, g_obj), cam, config=pcfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_object_surfels_match_jax(clip):
    """shaded_object_gaussians against JAX's: every field within 1e-5 of
    its largest magnitude."""
    inp, _, pin, _ = clip
    want = JCL.shaded_object_gaussians(inp, 1, JC.index_camera(inp.cams, 1))
    got = CL.shaded_object_gaussians(pin, 1, index_camera(pin.cams, 1))
    for f in convert.GAUSSIAN_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "active":
            assert np.array_equal(a, b)
            continue
        scale = max(np.abs(b).max(), 1e-12)
        # a quaternion and its negation are one rotation
        if f == "quats":
            a = a * np.sign((a * b).sum(-1, keepdims=True))
        assert np.abs(a - b).max() <= 1e-5 * scale, f


def test_fused_frame_matches_jax_fused_frame(jax_frame, port_fused):
    want = jax_frame["fused"]
    assert port_fused.shape == want.shape
    assert psnr(port_fused, want) > 40.0


def test_fused_frame_matches_own_multipass(clip):
    _, _, pin, pcfg = clip
    ref = CL.render_edited_frame(pin, 0, pcfg).numpy()
    fused = CL.render_edited_frame_fused(pin, 0, pcfg, shadow_scale=1).numpy()
    assert np.isfinite(fused).all()
    assert fused.min() >= 0.0 and fused.max() <= 1.0
    d = np.abs(ref - fused).max(axis=-1)
    assert np.quantile(d, 0.95) < 0.06, np.quantile(d, 0.95)
    assert d.mean() < 0.02, d.mean()


def test_fused_frame_shows_object_and_shadow(clip, port_fused):
    _, _, pin, pcfg = clip
    cam = index_camera(pin.cams, 0)
    bg_only = rasterize(pin.bg, cam, config=pcfg).color.clamp(0, 1)
    diff = np.abs(port_fused - bg_only.numpy()).max(-1)
    assert (diff > 0.1).sum() > 20


@pytest.mark.parametrize("supersample", [1, 2])
def test_render_clip(clip, supersample):
    _, _, pin, pcfg = clip
    frames = CL.render_clip(pin, 2, pcfg, fused=True,
                            supersample=supersample).numpy()
    h, w = pin.cams.height, pin.cams.width
    assert frames.shape == (2, h, w, 3)
    assert np.isfinite(frames).all()
    assert frames.min() >= 0.0 and frames.max() <= 1.0


def test_build_clip_inputs_matches_jax(clip):
    """The port's own assembly from the same host inputs gives the JAX
    package's arrays (equal texels and lights, float fields within
    rounding)."""
    from autovfx_tpu.render import meshsplat as JMS
    from autovfx_tpu_torch.physics.shapes import build_hulls
    from autovfx_tpu_torch.render import meshsplat as MS

    inp, _, pin, _ = clip
    corners = np.array([[x, y, z] for x in (-0.25, 0.25)
                        for y in (-0.25, 0.25) for z in (-0.25, 0.25)],
                       np.float32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
    surf = MS.sample_mesh_surfels(corners, faces, num_samples=3000,
                                  device="cpu")
    j_surf = JMS.sample_mesh_surfels(corners, faces, num_samples=3000)
    for k in MS.SURFEL_FIELDS:
        assert np.array_equal(surf[k].numpy(), j_surf[k]), k
    hull, _, _, _ = build_hulls([corners], device="cpu")
    got = CL.build_clip_inputs(
        bg=pin.bg, cams=pin.cams,
        objects=[{"scale": 1.0, "material": {"rgb": [0.9, 0.1, 0.1]}}],
        surfels=[surf], traj_pos=np.asarray(inp.traj_pos),
        traj_rot=np.asarray(inp.traj_rot), hull_shape=hull,
        env=np.asarray(inp.env), num_lights=8, device="cpu")
    for name in ("surf_points", "surf_normals", "surf_colors", "surf_radius",
                 "surf_body", "surf_rough", "surf_metal", "traj_pos",
                 "traj_rot", "traj_scale", "hull_planes", "hull_mask", "env",
                 "env_sh", "light_dirs", "light_weights"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(inp, name))
        assert a.shape == b.shape, name
        tol = 1e-5 * max(np.abs(b).max(), 1e-12) if a.dtype.kind == "f" else 0
        assert np.abs(a.astype(np.float64) - b).max() <= tol, name


def test_effects_keywords_raise(clip):
    """The effects keywords refuse malformed inputs: a ``smoke_traj`` that
    is neither (states, origin, extent, cfg) nor that with the origin
    cells, and a ``melt`` dict without its tracers' normals."""
    from autovfx_tpu_torch.physics.shapes import build_hulls

    _, _, pin, _ = clip
    corners = np.array([[x, y, z] for x in (-0.2, 0.2) for y in (-0.2, 0.2)
                        for z in (-0.2, 0.2)], np.float32)
    hull, _, _, _ = build_hulls([corners], device="cpu")
    surf = {"points": corners, "normals": corners, "colors": corners,
            "radius": 0.01}
    args = (pin.bg, pin.cams, [{"scale": 1.0}], [surf],
            np.zeros((1, 1, 3), np.float32),
            np.eye(3, dtype=np.float32)[None, None], hull,
            np.ones((4, 8, 3), np.float32))
    with pytest.raises(ValueError, match="smoke_traj"):
        CL.build_clip_inputs(*args, num_lights=2, smoke_traj=(None,),
                             device="cpu")
    with pytest.raises(KeyError, match="norm"):
        CL.build_clip_inputs(*args, num_lights=2,
                             melt={"pos": np.zeros((1, 8, 3), np.float32),
                                   "mask": np.ones(8, bool)},
                             device="cpu")
