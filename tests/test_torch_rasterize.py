"""The whole novel-view slice of the PyTorch port, on the CPU.

The golden scene (``make_garden_like(20_000, extent=2.67)`` at 128×96,
tile 16, made by the JAX package and carried across) goes through the
port's ``rasterize``, which on CPU tensors runs the plain versions of
all three kernels.  Budgets, as in ``tests/test_golden.py``:

- > 70 dB against ``garden_like_ref.npz``;
- > 100 dB against ``garden_like_oracle.npz``, alpha max abs < 1e-5,
  relative depth < 1e-4;
- > 90 dB against live JAX ``rasterize(backend="ref")``;
- > 40 dB against the JAX fused bf16 path (bf16 colors, chunk freeze);
- ``render()`` RGBA and normal against JAX ``render()`` at > 60 dB.
"""
import os

import numpy as np
import jax.experimental.pallas as pl
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.ops import blend_pallas as JBP
from autovfx_tpu.ops import preprocess_pallas as PP
from autovfx_tpu.ops.rasterize import RasterConfig as JConfig
from autovfx_tpu.ops.rasterize import rasterize as j_rasterize
from autovfx_tpu.ops.rasterize import render as j_render
from autovfx_tpu.utils.synthetic import make_garden_like
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.ops import rasterize as Rz

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(PP.pl, "pallas_call", patched)
    monkeypatch.setattr(JBP.pl, "pallas_call", patched)


@pytest.fixture(scope="module")
def scene():
    g = make_garden_like(20_000, extent=2.67)
    cam = JC.look_at_camera(
        [2.6, 0.0, 1.4], [0, 0, 0.2], [0, 0, 1],
        fx=96.0, fy=96.0, width=128, height=96,
    )
    gt = convert.gaussians(
        {f: np.asarray(getattr(g, f)) for f in convert.GAUSSIAN_FIELDS}
    )
    ct = convert.camera(
        {f: np.asarray(getattr(cam, f)) if f not in ("width", "height")
         else getattr(cam, f) for f in convert.CAMERA_FIELDS}
    )
    return g, cam, gt, ct


@pytest.fixture(scope="module")
def port_out(scene):
    _, _, gt, ct = scene
    return Rz.rasterize(gt, ct, config=Rz.RasterConfig(dup_budget=1 << 17))


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2)
    return -10.0 * np.log10(max(mse, 1e-30))


def test_golden_ref(port_out):
    gold = np.load(os.path.join(GOLDEN, "garden_like_ref.npz"))
    assert psnr(port_out.color.numpy(), gold["color"]) > 70.0
    assert not bool(port_out.overflow)


def test_golden_oracle(port_out):
    gold = np.load(os.path.join(GOLDEN, "garden_like_oracle.npz"))
    assert psnr(port_out.color.numpy(), gold["color"]) > 100.0
    assert np.abs(port_out.alpha.numpy() - gold["alpha"]).max() < 1e-5
    dd = np.abs(port_out.depth.numpy() - gold["depth"])
    assert (dd / np.maximum(gold["depth"], 1e-3)).max() < 1e-4


@pytest.mark.parametrize("tile", [16, 32])
def test_live_jax_ref_backend(scene, tile):
    g, cam, gt, ct = scene
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    ref = j_rasterize(g, cam, bg=bg, config=JConfig(
        dup_budget=1 << 17, backend="ref", tile=tile, chunk=256))
    out = Rz.rasterize(gt, ct, bg=torch.from_numpy(bg), config=Rz.RasterConfig(
        dup_budget=1 << 17, tile=tile))
    assert psnr(out.color.numpy(), ref.color) > 90.0
    assert np.abs(out.alpha.numpy() - np.asarray(ref.alpha)).max() < 1e-4
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))


def test_jax_fused_bf16_path(scene, port_out):
    g, cam, _, _ = scene
    cfg = JConfig(dup_budget=1 << 17, backend="pallas", tile=16,
                  chunk=256, feature_pack="bf16")
    ref = j_rasterize(g, cam, config=cfg, packed_rows=PP.pack_scene_rows(g))
    assert psnr(port_out.color.numpy(), ref.color) > 40.0


def test_render_rgba_and_normal(scene):
    g, cam, gt, ct = scene
    ref = j_render(g, cam, config=JConfig(dup_budget=1 << 17, backend="ref"))
    out = Rz.render(gt, ct, config=Rz.RasterConfig(dup_budget=1 << 17))
    assert psnr(out.rgba.numpy(), ref.rgba) > 60.0
    assert psnr(out.normal.numpy(), ref.normal) > 60.0
    assert out.rgba.shape == (96, 128, 4)


def test_mean2d_offset_belongs_to_training(scene, port_out):
    """The densification hook of the training path: a zero offset
    renders exactly as none (its gradients are tested with training)."""
    _, _, gt, ct = scene
    out = Rz.rasterize(gt, ct, config=Rz.RasterConfig(dup_budget=1 << 17),
                       mean2d_offset=torch.zeros(gt.capacity, 2))
    for a, b in zip(out, port_out):
        assert torch.equal(a, b)
