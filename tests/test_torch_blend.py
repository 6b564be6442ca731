"""Plain blend of the PyTorch port vs the JAX package, on the CPU.

The port's ``blend_ref`` (what kernel 3 is held against on the card) is
compared, as images, with JAX ``blend_ref.blend_tiles_ref`` and with the
Pallas ``_blend_fwd_call`` in interpret mode ("log" and "linear"
algorithms): color PSNR > 90 dB, alpha max abs < 1e-4.  Both sides see
the same JAX ``Splats2D``, carried into the port.  The kernels' warp-patch
skip (``blend_ref.patch_mask_plain``) must drop no blended pair and
leave the plain blend's alphas, and so its images, bit for bit as they
are.
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


def skip_scene(tile, scene):
    """The port's splats and binning of the golden view: as they are,
    saturated (opacity logit 5: the 0.99 clamp and the freeze bind), or
    thin (conics of 40 across and 0.04 along, alternately one pixel row
    tall and one column wide)."""
    import jax.numpy as jnp

    g, cam = golden_scene()
    if scene == "saturated":
        g = g.replace(opacity_logit=jnp.full_like(g.opacity_logit, 5.0))
    _, _, ps, pb = both(g, cam, tile)
    if scene == "thin":
        n = ps.depth.shape[0]
        row = torch.arange(n) % 2 == 0
        wide, thin = torch.tensor(0.04), torch.tensor(40.0)
        ps = ps._replace(conic=torch.stack([
            torch.where(row, wide, thin), torch.zeros(n),
            torch.where(row, thin, wide)], dim=1))
    return ps, pb


@pytest.mark.parametrize("scene", ["garden", "saturated", "thin"])
@pytest.mark.parametrize("tile", [16, 32])
def test_patch_skip_drops_no_blended_pair(tile, scene):
    """No blended pair lies in a cleared patch, and clearing the pairs
    there leaves every alpha the plain blend computes bit for bit as it
    is: the blend, a function of those alphas, is then unchanged."""
    ps, pb = skip_scene(tile, scene)
    n_tiles = pb.tile_range.shape[0]
    blended = cleared = pairs = 0
    for i in range(0, n_tiles, 4):
        tiles = torch.arange(i, min(i + 4, n_tiles))
        d, live = blend_ref.blended_pairs(pb, ps, tile, tiles)
        kept = blend_ref._patch_kept(d, ps, pb, tile)
        assert not bool((live & ~kept).any()), f"tiles {i}.."
        g = d.gid
        alpha = blend_ref.compute_alpha(ps.mean2d[g], ps.conic[g],
                                        ps.opacity[g], d.px, d.py)
        skipped = torch.where(kept, alpha, torch.zeros_like(alpha))
        assert torch.equal(alpha, skipped), f"tiles {i}.."
        blended += int(live.sum())
        cleared += int((~kept).sum())
        pairs += kept.numel()
    assert blended > 100_000
    assert cleared > 0.5 * pairs  # the skip has work to save


def test_patch_mask_plain_edge_cases():
    """Every bit where an input is not finite or the conic is not
    positive definite; none where the opacity cannot reach 1/255; a
    point-like splat only in its own patch."""
    xy = torch.tensor([[40.0, 12.0]] * 5)
    conic = torch.tensor([[1.0, 0.0, 1.0], [float("nan"), 0.0, 1.0],
                          [1.0, 2.0, 1.0], [1.0, 0.0, 1.0], [50.0, 0.0, 50.0]])
    op = torch.tensor([0.5, 0.5, 0.5, 1.0 / 300.0, 0.9])
    o = torch.tensor([32] * 5)
    m = blend_ref.patch_mask_plain(xy, conic, op, o, torch.zeros(5), 32)
    assert m[1].all() and m[2].all() and not m[3].any()
    # at (8, 12) of the tile: patch 0 spans x 0-15, y 0-7; patch 2 y 8-15
    assert m[4].tolist() == [False, False, True, False, False, False,
                             False, False]
    assert m[0, 2] and m[0].sum() < 8
    assert blend_ref.pixel_patch(32)[12 * 32 + 8] == 2
    assert blend_ref.pixel_patch(16)[7 * 16 + 15] == 3
