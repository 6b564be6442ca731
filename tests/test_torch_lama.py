"""The port's LaMa network and inpainting wrappers against the JAX
package's, on the CPU.

- ``lama_generator`` on one tiny state dict (``tests/test_lama.py``'s
  ``tiny_state_dict``) against JAX's at atol 1e-5 / rtol 1e-4, at 64×48
  and at 72×40, whose 1/4-resolution width (the tiny net's bottleneck,
  two downsamples) is odd;
- ``inpaint_with_params``: uint8 within 1 of JAX's on ≥ 99.9 % of the
  values, and exact outside the hole;
- ``convert.lama_params_from_jax`` equal to the port's own converter;
- checkpoint files and directories, ``try_inpaint`` without one;
- ``inpaint_img_with_lama`` without a checkpoint (both call OpenCV's
  TELEA), ``inpaint_img`` and ``fill_img_with_sd``: the same images and
  files as JAX's.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import test_lama as TL  # noqa: E402
from autovfx_tpu.perception import lama_jax  # noqa: E402
from autovfx_tpu.perception import wrappers as JW  # noqa: E402
from autovfx_tpu_torch import convert  # noqa: E402
from autovfx_tpu_torch.perception import lama  # noqa: E402
from autovfx_tpu_torch.perception import wrappers as W  # noqa: E402
from autovfx_tpu_torch.utils import png  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def nets():
    """One tiny state dict converted by both packages."""
    sd = TL.tiny_state_dict()
    return sd, lama_jax.convert_torch_state_dict(sd), \
        lama.convert_torch_state_dict(sd, device="cpu")


def _saved(sd, path):
    torch.save({"state_dict": {
        ("generator." + k if k.startswith("model.") else k):
        torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, str(path))


@pytest.mark.parametrize("h,w", [(48, 64), (40, 72)])
def test_generator_matches_jax(nets, h, w):
    _, jp, tp = nets
    x = np.random.default_rng(h).normal(0, 1, (1, h, w, 4)).astype(np.float32)
    want = np.asarray(lama_jax.lama_generator(jp, x))
    got = lama.lama_generator(tp, torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert got.shape == (1, 3, h, w)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=ATOL, rtol=RTOL)


def test_inpaint_with_params_matches_jax(nets):
    _, jp, tp = nets
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    mask = np.zeros((37, 53), np.uint8)
    mask[10:20, 15:30] = 1
    want = lama_jax.inpaint_with_params(jp, img, mask)
    got = lama.inpaint_with_params(tp, img, mask, device="cpu")
    assert got.shape == img.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    keep = mask == 0
    # outside the hole the float round trip of the 8-bit input is the
    # same in both: equal to JAX's, and within 1 of the input
    assert (got[keep] == want[keep]).all()
    assert np.abs(got[keep].astype(int) - img[keep]).max() <= 1
    # a float image passes through outside the hole, truncated
    imgf = rng.random((40, 48, 3)).astype(np.float32)
    m = np.zeros((40, 48), bool)
    m[5:20, 8:30] = True
    out = lama.inpaint_with_params(tp, imgf, m, device="cpu")
    assert (out[~m] == (imgf[~m] * 255).astype(np.uint8)).all()


def test_converter_from_jax_equals_the_port_converter(nets):
    import jax

    _, jp, tp = nets
    got = convert.lama_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                       device="cpu")
    flat = lambda p: jax.tree_util.tree_leaves(
        [p.init, p.down, p.blocks, p.up, p.out_w, p.out_b])
    a, b = flat(got), flat(tp)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)


def test_checkpoint_file_and_directory(nets, tmp_path):
    sd, _, tp = nets
    f = tmp_path / "tiny.ckpt"
    _saved(sd, f)
    d = tmp_path / "big-lama" / "models"
    d.mkdir(parents=True)
    _saved(sd, d / "best.ckpt")
    for path in (f, tmp_path / "big-lama"):
        p = lama.load_lama_params(str(path), device="cpu")
        assert len(p.blocks) == 2 and len(p.up) == 2
        assert torch.equal(p.out_w, tp.out_w)
    assert lama.resolve_ckpt_file(str(tmp_path / "big-lama")) == str(
        d / "best.ckpt")


def test_try_inpaint_and_the_wrapper_with_a_checkpoint(nets, tmp_path,
                                                        monkeypatch):
    sd, jp, _ = nets
    f = tmp_path / "tiny.ckpt"
    _saved(sd, f)
    monkeypatch.delenv("AUTOVFX_LAMA_CKPT", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    img = np.random.default_rng(4).integers(0, 256, (24, 32, 3), np.uint8)
    mask = np.zeros((24, 32), np.uint8)
    mask[8:16, 8:20] = 255
    assert lama.default_ckpt_path() is None
    assert lama.try_inpaint(img, mask, device="cpu") is None
    monkeypatch.setenv("AUTOVFX_LAMA_CKPT", str(f))
    got = W.inpaint_img_with_lama(img, mask, device="cpu")
    want = lama_jax.inpaint_with_params(jp, img, mask)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # a checkpoint that is there but broken raises: no TELEA after it
    bad = tmp_path / "broken.ckpt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        W.inpaint_img_with_lama(img, mask, ckpt_path=str(bad), device="cpu")


def test_wrapper_without_checkpoint_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("AUTOVFX_LAMA_CKPT", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    rng = np.random.default_rng(5)
    img = rng.random((40, 56, 3)).astype(np.float32)
    mask = np.zeros((40, 56), bool)
    mask[10:25, 12:40] = True
    got = W.inpaint_img_with_lama(img, mask, device="cpu")
    want = JW.inpaint_img_with_lama(img, mask)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    cache = tmp_path / "cached.png"
    png.write_png(str(cache), want[..., :1].repeat(3, 2))
    assert np.array_equal(W.inpaint_img_with_lama(img, mask,
                                                  cache_path=str(cache)),
                          JW.inpaint_img_with_lama(img, mask,
                                                   cache_path=str(cache)))


def test_inpaint_img_writes_the_files_of_jax(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.delenv("AUTOVFX_LAMA_CKPT", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    rgba = np.full((64, 96, 4), 255, np.uint8)
    rgba[..., 0] = 40
    rgba[..., 1] = np.arange(96, dtype=np.uint8)[None, :] + 100
    rgba[20:36, 30:50, 3] = 0
    paths = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        p = str(d / "pano.png")
        Image.fromarray(rgba).save(p)
        fn = JW.inpaint_img if who == "jax" else W.inpaint_img
        paths[who] = fn(p, dilate_kernel_size=4, erode_kernel_size=2)
    for suffix in ("_inpaint.png", "_mask.png"):
        got = png.read_png(paths["port"].replace("_inpaint.png", suffix))
        want = np.asarray(Image.open(paths["jax"].replace("_inpaint.png",
                                                          suffix)))
        assert np.array_equal(got, want), suffix


def test_fill_img_with_sd_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("AUTOVFX_ALLOW_HUB_DOWNLOAD", raising=False)
    monkeypatch.delenv("AUTOVFX_LAMA_CKPT", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    img = np.full((32, 32, 3), 90, np.uint8)
    img[:, 16:] = 200
    mask = np.zeros((32, 32), np.uint8)
    mask[8:16, 8:24] = 255
    cache = tmp_path / "sd.png"
    png.write_png(str(cache), np.full((32, 32, 3), 7, np.uint8))
    for c in (str(cache), None):
        got = W.fill_img_with_sd(img, mask, "a table", c, device="cpu")
        want = JW.fill_img_with_sd(img, mask, "a table", c)
        assert np.array_equal(got, want)


def test_no_checkpoint_and_no_cv2_names_both(tmp_path, monkeypatch):
    monkeypatch.delenv("AUTOVFX_LAMA_CKPT", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(W.PrecomputedInputMissing,
                       match=r"AUTOVFX_LAMA_CKPT.*cv2"):
        W.inpaint_img_with_lama(np.zeros((8, 8, 3), np.uint8),
                                np.ones((8, 8)), device="cpu")
