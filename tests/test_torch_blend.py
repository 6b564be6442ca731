"""Plain blend of the PyTorch port vs the JAX package, on the CPU.

The port's ``blend_ref`` (what kernel 3 is held against on the card) is
compared, as images, with JAX ``blend_ref.blend_tiles_ref`` and with the
Pallas ``_blend_fwd_call`` in interpret mode ("log" and "linear"
algorithms): color PSNR > 90 dB, alpha max abs < 1e-4.  Both sides see
the same JAX ``Splats2D``, carried into the port.
"""
import numpy as np
import jax.experimental.pallas as pl
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.ops import binning as JB
from autovfx_tpu.ops import blend_pallas as JBP
from autovfx_tpu.ops import blend_ref as JR
from autovfx_tpu.ops import projection as JPr
from autovfx_tpu.utils.synthetic import make_garden_like, make_scene
from autovfx_tpu_torch.ops import binning, blend_cuda, blend_ref, projection

W, H = 128, 96
BUDGET = 1 << 17


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(JBP.pl, "pallas_call", patched)


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2)
    return -10.0 * np.log10(max(mse, 1e-30))


def golden_scene():
    g = make_garden_like(20_000, extent=2.67)
    cam = JC.look_at_camera(
        [2.6, 0.0, 1.4], [0, 0, 0.2], [0, 0, 1],
        fx=96.0, fy=96.0, width=W, height=H,
    )
    return g, cam


def both(g, cam, tile):
    """(JAX splats, JAX binned, port splats, port binned) of one view."""
    js = JPr.preprocess(g, cam, tile=tile)
    jb = JB.bin_splats(js, cam.width, cam.height, BUDGET, tile=tile,
                       chunk=256)
    ps = projection.Splats2D(*[torch.tensor(np.asarray(x)) for x in js])
    pb = binning.bin_splats(ps, cam.width, cam.height, BUDGET, tile=tile)
    return js, jb, ps, pb


def port_image(ps, pb, cam, tile):
    return blend_cuda.blend(pb, ps, cam.width, cam.height, tile)


def check(port, color, alpha):
    p_color, _, p_alpha = port
    assert psnr(p_color.numpy(), color) > 90.0, psnr(p_color.numpy(), color)
    da = np.abs(p_alpha.numpy() - np.asarray(alpha)).max()
    assert da < 1e-4, da


@pytest.mark.parametrize("tile", [16, 32])
def test_matches_jax_blend_ref(tile):
    g, cam = golden_scene()
    js, jb, ps, pb = both(g, cam, tile)
    feat = JBP.pack_gaussian_features(js)[:, jb.gid]
    t = JR.blend_tiles_ref_from_feat(jb, feat, tile=tile)
    tx, ty = jb.num_tiles_x, jb.num_tiles_y
    img = lambda x: JR.assemble_image(x, tx, ty, W, H, tile=tile)
    port = port_image(ps, pb, cam, tile)
    check(port, img(t.color), img(t.alpha))
    np.testing.assert_allclose(port[1].numpy(), np.asarray(img(t.depth)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("algo", ["log", "linear"])
def test_matches_pallas_forward_kernel(algo):
    g, cam = make_scene(n=2000, width=64, height=48, key=4)
    js, jb, ps, pb = both(g, cam, 16)
    feat = JBP.pack_gaussian_features(js)[:, jb.gid]
    tx, ty = jb.num_tiles_x, jb.num_tiles_y
    out = JBP._blend_fwd_call(feat, jb.tile_start, jb.tile_chunks, tx * ty,
                              tx, 16, 256, algo=algo)
    rows = JR.assemble_rows(out, tx, ty, cam.width, cam.height, tile=16)
    port = port_image(ps, pb, cam, 16)
    check(port, np.moveaxis(np.asarray(rows[0:3]), 0, -1), rows[4])


def test_saturated_freeze_matches_jax():
    """Opaque overlapping splats: most pixels hit the T < 1e-4 freeze."""
    import jax
    import jax.numpy as jnp

    n = 60
    g, cam = make_scene(n=n, width=32, height=32, key=3)
    g = g.replace(
        xyz=0.05 * jax.random.normal(jax.random.PRNGKey(3), (n, 3)),
        opacity_logit=jnp.full((n,), 5.0),
        log_scales=jnp.full((n, 3), np.log(0.3)),
    )
    js, jb, ps, pb = both(g, cam, 16)
    feat = JBP.pack_gaussian_features(js)[:, jb.gid]
    t = JR.blend_tiles_ref_from_feat(jb, feat, tile=16)
    img = lambda x: JR.assemble_image(x, 2, 2, 32, 32, tile=16)
    port = port_image(ps, pb, cam, 16)
    assert float(port[2].max()) > 0.999
    check(port, img(t.color), img(t.alpha))


def test_tile_subset_equals_full_frame():
    g, cam = golden_scene()
    _, _, ps, pb = both(g, cam, 32)
    full = blend_ref.blend_tiles_ref(pb, ps, tile=32)
    pick = torch.tensor([11, 0, 5, 5, 7])
    sub = blend_ref.blend_tiles_ref(pb, ps, tile=32, tiles=pick)
    for a, b in zip(sub, full):
        torch.testing.assert_close(a, b[pick], rtol=1e-6, atol=1e-6)
    # split_tiles inverts assemble_image on the image's own pixels
    img = blend_ref.assemble_image(full.color, 4, 3, W, H, tile=32)
    back = blend_ref.split_tiles(img, 4, 3, tile=32)
    inside = blend_ref.split_tiles(torch.ones(H, W), 4, 3, tile=32) > 0
    torch.testing.assert_close(back[inside], full.color[inside])
