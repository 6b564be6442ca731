"""Plain blend backward of the PyTorch port vs the JAX package, on the CPU.

``blend_ref.blend_tiles_ref_bwd`` is what kernel 4 (``csrc/blend_bwd.cu``)
is held against on the card.  Both packages see the same JAX
``Splats2D`` (carried into the port) and the same per-pixel output
gradients (numpy, seeded):

- where the 0.99 clamp does not bind (opacity < 0.99), against
  ``jax.grad`` through the JAX reference blend; per field, the error
  over the field's largest magnitude is below 2e-4
  (``tests/test_pallas_blend.py:181-186``);
- on a saturated scene where the clamp binds (opacity 0.9933), against
  the JAX kernel 4 (``blend_pallas_bwd.blend_bwd_call``) run in
  interpret mode, its per-duplicate rows summed per Gaussian in numpy
  and d log-op / op taken for d opacity: 5e-4 on the same scale.
"""
import numpy as np
import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl
import pytest
import torch

from autovfx_tpu.ops import binning as JB
from autovfx_tpu.ops import blend_pallas as JBP
from autovfx_tpu.ops import blend_pallas_bwd as JBB
from autovfx_tpu.ops import blend_ref as JR
from autovfx_tpu.ops import projection as JPr
from autovfx_tpu.utils.synthetic import make_scene
from autovfx_tpu_torch.ops import binning, blend_ref
from autovfx_tpu_torch.ops.projection import Splats2D

FIELDS = ("mean2d", "conic", "opacity", "color", "depth")
BUDGET = 1 << 14


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(JBP.pl, "pallas_call", patched)
    monkeypatch.setattr(JBB.pl, "pallas_call", patched)


def port_splats(s) -> Splats2D:
    return Splats2D(*(torch.from_numpy(np.array(x)) for x in s))


def out_grads(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, w, 3)).astype(np.float32),
            0.1 * rng.standard_normal((h, w)).astype(np.float32),
            0.2 * rng.standard_normal((h, w)).astype(np.float32))


def port_bwd(js, cam, tile, grads, tiles=None):
    s = port_splats(js)
    b = binning.bin_splats(s, cam.width, cam.height, BUDGET, tile=tile)
    return blend_ref.blend_tiles_ref_bwd(
        b, s, *(torch.from_numpy(x) for x in grads), tile=tile, tiles=tiles)


def assert_fields_close(got, want, atol):
    for f in FIELDS:
        a = np.asarray(want[f], np.float64)
        b = getattr(got, f).numpy().astype(np.float64).reshape(a.shape)
        assert np.isfinite(b).all(), f
        scale = np.abs(a).max() + 1e-6
        err = np.abs(b - a).max() / scale
        assert err < atol, (f, err)


def saturated_scene(n, w, h, key):
    g, cam = make_scene(n=n, width=w, height=h, key=key)
    g = g.replace(
        xyz=0.05 * jax.random.normal(jax.random.PRNGKey(key), (n, 3)),
        opacity_logit=jnp.full((n,), 5.0),
        log_scales=jnp.full((n, 3), np.log(0.25)),
    )
    return g, cam


@pytest.mark.parametrize("tile,n,w,h,key", [(16, 120, 48, 32, 1),
                                            (32, 200, 64, 48, 0)])
def test_matches_jax_autodiff(tile, n, w, h, key):
    g, cam = make_scene(n=n, width=w, height=h, key=key)
    js = JPr.preprocess(g, cam, tile=tile)
    assert float(js.opacity.max()) < 0.99  # the clamp cannot bind
    jb = JB.bin_splats(js, w, h, BUDGET, tile=tile)
    grads = out_grads(h, w, seed=key)
    tx, ty = jb.num_tiles_x, jb.num_tiles_y

    def loss(mean2d, conic, opacity, color, depth):
        s = js._replace(mean2d=mean2d, conic=conic, opacity=opacity,
                        color=color, depth=depth)
        feat = JBP.pack_gaussian_features(s)[:, jb.gid]
        t = JR.blend_tiles_ref_from_feat(jb, feat, tile=tile)
        img = lambda x: JR.assemble_image(x, tx, ty, w, h, tile=tile)
        return (jnp.sum(img(t.color) * grads[0])
                + jnp.sum(img(t.depth) * grads[1])
                + jnp.sum(img(t.alpha) * grads[2]))

    want = jax.grad(loss, argnums=tuple(range(5)))(
        *(getattr(js, f) for f in FIELDS))
    got = port_bwd(js, cam, tile, grads)
    assert_fields_close(got, dict(zip(FIELDS, want)), atol=2e-4)


@pytest.mark.parametrize("tile", [16, 32])
def test_matches_jax_kernel4_where_the_clamp_binds(tile):
    n, w, h = 40, 32, 16
    g, cam = saturated_scene(n, w, h, key=5)
    js = JPr.preprocess(g, cam, tile=tile)
    jb = JB.bin_splats(js, w, h, BUDGET, tile=tile)
    feat = JBP.pack_gaussian_features(js)[:, jb.gid]
    # the clamp binds somewhere: op·exp(power) > 0.99 at a pixel center
    assert float(js.opacity.max()) > 0.99
    grads = out_grads(h, w, seed=5)
    tx, ty = jb.num_tiles_x, jb.num_tiles_y
    split = lambda x: blend_ref.split_tiles(torch.from_numpy(x), tx, ty,
                                            tile).numpy()
    g_out = np.zeros((tx * ty, JBP.OUT_ROWS, tile * tile), np.float32)
    g_out[:, 0:3] = split(grads[0]).transpose(0, 2, 1)
    g_out[:, 3] = split(grads[1])
    g_out[:, 4] = split(grads[2])
    d_feat = np.asarray(JBB.blend_bwd_call(
        feat, jb.tile_start, jb.tile_chunks, jnp.asarray(g_out), tx * ty, tx,
        tile, JB.CHUNK))
    per_g = np.zeros((n + 1, 10), np.float64)  # row n: the inert pads
    np.add.at(per_g, np.asarray(jb.gid), d_feat[:10].T)
    op = np.asarray(js.opacity, np.float64)
    d_op = np.where(op > 0, per_g[:n, 5] / np.maximum(op, 1e-30), 0.0)
    want = {"mean2d": per_g[:n, 0:2], "conic": per_g[:n, 2:5],
            "opacity": d_op, "color": per_g[:n, 6:9], "depth": per_g[:n, 9]}
    got = port_bwd(js, cam, tile, grads)
    assert_fields_close(got, want, atol=5e-4)


def one_tile_splats(mean2d, conic, opacity, depth) -> Splats2D:
    n = len(opacity)
    f = lambda x: torch.tensor(np.asarray(x, np.float32))
    return Splats2D(mean2d=f(mean2d), conic=f(conic),
                    color=torch.full((n, 3), 0.5), opacity=f(opacity),
                    depth=f(depth),
                    radius=torch.full((n,), 50, dtype=torch.int32),
                    tile_min=torch.zeros((n, 2), dtype=torch.int32),
                    tile_max=torch.ones((n, 2), dtype=torch.int32),
                    tiles_touched=torch.ones(n, dtype=torch.int32))


@pytest.mark.parametrize("case", ["alpha_min", "freeze"])
def test_ambiguous_pixels_are_the_decisions_on_a_threshold(case):
    """``ambiguous_pixels`` marks the pixels where a decision about a
    duplicate sits on its threshold, and no other: a splat whose alpha is
    1/255 on the circle x² + y² = 100 around its center; two opaque
    splats on one center, where T·(1 - alpha) = 0.01·0.01 = 1e-4 there
    (and where power = 0 exactly, which no rounding moves)."""
    c, conic = 16.0, [0.01, 0.0, 0.01]
    if case == "alpha_min":
        s = one_tile_splats([[c, c]], [conic], [np.exp(0.5) / 255], [1.0])
        want = {(x, y) for x in range(32) for y in range(32)
                if (x - c) ** 2 + (y - c) ** 2 == 100}
    else:
        s = one_tile_splats([[c, c]] * 2, [conic] * 2, [0.9933] * 2,
                            [1.0, 2.0])
        want = {(16, 16)}
    b = binning.bin_splats(s, 32, 32, 64, tile=32)
    marked = blend_ref.ambiguous_pixels(b, s, tile=32)
    got = {(p % 32, p // 32) for p in torch.nonzero(marked[0])[:, 0].tolist()}
    assert got == want


def test_subset_equals_all_tiles_with_zeroed_grads():
    """What the card's check relies on: the backward over a subset of
    tiles equals the backward over every tile with the output gradients
    zeroed outside the subset."""
    tile, w, h = 16, 64, 48
    g, cam = make_scene(n=200, width=w, height=h, key=3)
    js = JPr.preprocess(g, cam, tile=tile)
    grads = out_grads(h, w, seed=3)
    tx, ty = (w + tile - 1) // tile, (h + tile - 1) // tile
    tiles = torch.tensor([0, 5, 6, 11])
    keep = np.zeros((ty * tile, tx * tile), bool)
    for t in tiles.tolist():
        y, x = divmod(t, tx)
        keep[y * tile:(y + 1) * tile, x * tile:(x + 1) * tile] = True
    keep = keep[:h, :w]
    zeroed = (grads[0] * keep[..., None], grads[1] * keep, grads[2] * keep)
    sub = port_bwd(js, cam, tile, grads, tiles=tiles)
    full = port_bwd(js, cam, tile, zeroed)
    for f in FIELDS:
        torch.testing.assert_close(getattr(sub, f), getattr(full, f),
                                   rtol=1e-5, atol=1e-6)
