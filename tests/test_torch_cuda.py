"""The port's CUDA kernels against their plain versions, on the card.

Covers what ``chip_smoke.py``'s main path does not launch: the kernel
options (override color, SH degree, scaling modifier, inactive splats),
empty and fully culled views, an overflowing budget, ``render``'s normal
pass, and the wrappers' refusals; and for the training path, the
backward kernels under those options, the differentiable ``rasterize``
and one ``train_step`` against the CPU path.  The tolerances are
``chip_smoke.py``'s.

Needs an NVIDIA GPU and ``nvcc``; skipped elsewhere.  It imports neither
JAX nor the JAX package, so it runs on a machine without them, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

import autovfx_tpu_torch as P
import chip_smoke as cs
from autovfx_tpu_torch.core.cameras import look_at_camera
from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS
from autovfx_tpu_torch.ops import (
    binning, blend_cuda, fill_cuda, preprocess_cuda, projection,
)
from autovfx_tpu_torch.utils.synthetic import make_garden_like

pytestmark = pytest.mark.cuda
W, H = 200, 120


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(dev):
    g = make_garden_like(6000, seed=3, extent=2.67, device=dev)
    cam = look_at_camera([2.6, 0.4, 1.2], [0, 0, 0.2], [0, 0, 1], fx=150.0,
                         fy=150.0, width=W, height=H, device=dev)
    return g, cam


def with_fields(g, **kw):
    fields = {f: getattr(g, f) for f in ("xyz", "sh_dc", "sh_rest",
                                         "log_scales", "quats",
                                         "opacity_logit", "active")}
    fields.update(kw)
    return type(g)(**fields)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("kw", [
    {}, {"sh_degree": 0}, {"sh_degree": 2}, {"scaling_modifier": 0.7},
    {"override_color": True}, {"mean2d_offset": True},
])
def test_preprocess_options(scene, tile, kw):
    g, cam = scene
    gen = torch.Generator(device=g.xyz.device).manual_seed(1)
    if kw.get("override_color"):
        kw = {"override_color": torch.rand(g.capacity, 3, generator=gen,
                                           device=g.xyz.device)}
    if kw.get("mean2d_offset"):  # moves the tile rects too
        kw = {"mean2d_offset": 40.0 * torch.rand(
            g.capacity, 2, generator=gen, device=g.xyz.device) - 20.0}
    got = preprocess_cuda.preprocess_kernel(g, cam, tile=tile, **kw)
    want = projection.preprocess(g, cam, tile=tile, **kw)
    cs.check_preprocess(got, want, f"tile {tile} {sorted(kw)}")


def test_inactive_splats_are_culled(scene):
    g, cam = scene
    active = torch.arange(g.capacity, device=g.xyz.device) % 3 != 0
    g = with_fields(g, active=active)
    got = preprocess_cuda.preprocess_kernel(g, cam, tile=16)
    cs.check_preprocess(got, projection.preprocess(g, cam, tile=16),
                        "inactive")
    assert int(got.tiles_touched[~active].max()) == 0
    assert float(got.opacity[~active].abs().max()) == 0.0


@pytest.mark.parametrize("tile", [16, 32])
def test_rasterize_matches_plain_path(scene, tile):
    g, cam = scene
    cfg = P.RasterConfig(dup_budget=1 << 16, tile=tile)
    bg = torch.tensor([0.1, 0.2, 0.3], device=g.xyz.device)
    before = cs.counters(P.ops)
    out = P.rasterize(g, cam, bg=bg, config=cfg)
    after = cs.counters(P.ops)
    forward = ("preprocess", "duplicate_with_keys", "blend_fwd")
    assert all(after[k] == before[k] + (k in forward) for k in after), (
        before, after)  # once each, and no backward kernel
    s = projection.preprocess(g, cam, tile=tile)
    b = binning.bin_splats(s, W, H, cfg.dup_budget, tile=tile)
    tiles = torch.arange(b.tile_range.shape[0], device=g.xyz.device)
    images = (out.color - (1.0 - out.alpha)[..., None] * bg, out.depth,
              out.alpha)
    cs.check_blend(P, b, s, images, tiles, W, H, tile, f"tile {tile}")
    assert not bool(out.overflow)
    assert out.radii.shape == (g.capacity,)


def test_render_normal_pass_matches_cpu(scene):
    g, cam = scene
    cfg = P.RasterConfig(dup_budget=1 << 16, tile=16)
    gpu = P.render(g, cam, config=cfg)
    g_cpu = with_fields(g, **{f: getattr(g, f).cpu() for f in (
        "xyz", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logit",
        "active")})
    cam_cpu = look_at_camera([2.6, 0.4, 1.2], [0, 0, 0.2], [0, 0, 1],
                             fx=150.0, fy=150.0, width=W, height=H)
    cpu = P.render(g_cpu, cam_cpu, config=cfg)
    assert cs.psnr(gpu.rgba.cpu(), cpu.rgba) > 60.0
    assert cs.psnr(gpu.normal.cpu(), cpu.normal) > 60.0


def test_empty_and_culled_views(scene, dev):
    g, cam = scene
    cfg = P.RasterConfig(dup_budget=1 << 12, tile=32)
    behind = with_fields(g, xyz=torch.tensor(  # every splat behind the camera
        [10.0, 2.0, 5.0], device=dev).expand_as(g.xyz).contiguous())
    for scene_g in (behind, with_fields(g, active=torch.zeros_like(g.active))):
        out = P.rasterize(scene_g, cam, config=cfg)
        assert float(out.alpha.abs().max()) == 0.0
        assert int(out.radii.abs().max()) == 0
    empty = with_fields(g, **{f: getattr(g, f)[:0] for f in (
        "xyz", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logit",
        "active")})
    out = P.rasterize(empty, cam, config=cfg)
    assert out.color.shape == (H, W, 3) and float(out.alpha.max()) == 0.0


def test_overflow_is_flagged_and_finite(scene):
    g, cam = scene
    s = preprocess_cuda.preprocess_kernel(g, cam, tile=16)
    need = int(binning.required_budget(s))
    b = binning.bin_splats(s, W, H, need // 3, tile=16)
    assert bool(b.overflow) and int(b.total_dups) == need
    assert int(b.tile_range[-1, 1]) == need // 3
    images = blend_cuda.blend_kernel(b, s, W, H, 16)
    assert all(bool(torch.isfinite(x).all()) for x in images)
    tiles = torch.arange(b.tile_range.shape[0], device=s.depth.device)
    cs.check_blend(P, b, s, images, tiles, W, H, 16, "overflow")
    tx, ty = projection.num_tiles(W, H, 16)
    cs.check_duplicates(P, s, tx, tx * ty, need // 3, "overflow")


def test_wrappers_refuse_what_kernels_do_not_take(scene):
    g, cam = scene
    cam_cpu = look_at_camera([2.6, 0.4, 1.2], [0, 0, 0.2], [0, 0, 1],
                             fx=150.0, fy=150.0, width=W, height=H)
    with pytest.raises(ValueError, match="CUDA"):
        preprocess_cuda.preprocess_kernel(g, cam_cpu)
    rgb = torch.rand(3, g.capacity, device=g.xyz.device).t()  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        preprocess_cuda.preprocess_kernel(g, cam, override_color=rgb)
    s = preprocess_cuda.preprocess_kernel(g, cam, tile=16)
    b = binning.bin_splats(s, W, H, 1 << 16, tile=16)
    with pytest.raises(ValueError, match="tiles"):
        blend_cuda.blend_kernel(b, s, W, H, 8)
    counts = s.tiles_touched
    with pytest.raises(ValueError, match="int64"):
        fill_cuda.duplicate_with_keys_kernel(
            counts, counts, s.tile_min, s.tile_max, s.depth, 13, 104, 100)


# ---- the training path ---------------------------------------------------


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("kw", [
    {}, {"sh_degree": 0}, {"sh_degree": 2}, {"scaling_modifier": 0.7},
    {"override_color": True}, {"inactive": True},
])
def test_preprocess_bwd_options(scene, tile, kw):
    g, cam = scene
    kw = dict(kw)
    if kw.pop("inactive", False):
        g = with_fields(g, active=torch.arange(g.capacity,
                                               device=g.xyz.device) % 3 != 0)
    if kw.get("override_color"):
        gen = torch.Generator(device=g.xyz.device).manual_seed(2)
        kw["override_color"] = torch.rand(g.capacity, 3, generator=gen,
                                          device=g.xyz.device)
    s = projection.preprocess(g, cam, tile=tile, **kw)
    d = cs.splat_grads(P, g.capacity, np.random.default_rng(tile))
    got = preprocess_cuda.preprocess_bwd_kernel(g, cam, s.tiles_touched, d,
                                                tile=tile, **kw)
    want = preprocess_cuda.preprocess_bwd_plain(g, cam, s.tiles_touched, d,
                                                tile=tile, **kw)
    cs.check_fields(got, want, cs.PRE_BWD_TOL, f"tile {tile} {sorted(kw)}")
    if "override_color" in kw:
        assert torch.equal(got.override_color, d.color)
        assert float(got.sh_dc.abs().max()) == 0.0


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("logit", [None, cs.SATURATED_LOGIT])
def test_blend_bwd_matches_plain(scene, tile, logit):
    g, cam = scene
    if logit is not None:
        g = with_fields(g, opacity_logit=torch.full_like(g.opacity_logit,
                                                         logit))
    cs.check_blend_bwd(P, g, cam, tile, np.random.default_rng(7),
                       f"tile {tile} logit {logit}")


def test_blend_bwd_on_a_tile_subset(scene):
    g, cam = scene
    tiles = torch.tensor([0, 3, 17, 30], device=g.xyz.device)
    cs.check_blend_bwd(P, g, cam, 16, np.random.default_rng(8), "subset",
                       tiles=tiles)


def _cpu(x):
    return type(x)(**{f.name: getattr(x, f.name).cpu()
                      if torch.is_tensor(getattr(x, f.name))
                      else getattr(x, f.name)
                      for f in dataclasses.fields(x)})


def test_differentiable_rasterize_matches_cpu(scene):
    """Every parameter's and ``mean2d_offset``'s gradient through the
    kernels against the CPU path's (plain backwards), per field within
    1e-3 of its largest magnitude."""
    g, cam = scene
    cfg = P.RasterConfig(dup_budget=1 << 16, tile=32)
    rng = np.random.default_rng(9)
    target = torch.from_numpy(rng.random((H, W, 3), np.float32))
    grads = {}
    for dev, gg, cc in (("cuda", g, cam), ("cpu", _cpu(g), _cpu(cam))):
        leaves = {f: getattr(gg, f).clone().requires_grad_(True)
                  for f in PARAM_FIELDS}
        off = torch.zeros((gg.capacity, 2), device=dev, requires_grad=True)
        out = P.rasterize(dataclasses.replace(gg, **leaves), cc, config=cfg,
                          mean2d_offset=off)
        loss = ((out.color - target.to(dev)) ** 2).mean() + out.depth.mean()
        loss.backward()
        grads[dev] = {f: v.grad.cpu() for f, v in leaves.items()}
        grads[dev]["mean2d_offset"] = off.grad.cpu()
    for f, want in grads["cpu"].items():
        got = grads["cuda"][f]
        err = (got - want).abs().max().item() / (want.abs().max().item()
                                                 + 1e-12)
        assert err < 1e-3, (f, err)


def test_train_step_matches_cpu(scene):
    from autovfx_tpu_torch.train import trainer as T

    g, cam = scene
    cfg = T.TrainConfig(raster=P.RasterConfig(dup_budget=1 << 16, tile=16),
                        spatial_lr_scale=2.67)
    target = torch.from_numpy(
        np.random.default_rng(10).random((H, W, 3), np.float32))
    before = cs.counters(P.ops)
    s_gpu, aux_gpu = T.train_step(T.init_state(g), cam, target.cuda(), cfg)
    after = cs.counters(P.ops)
    assert all(after[k] == before[k] + (k != "blend_fwd") for k in after), (
        before, after)  # once each; kernel 3 only as its training variant
    s_cpu, aux_cpu = T.train_step(T.init_state(_cpu(g)), _cpu(cam), target,
                                  cfg)
    torch.testing.assert_close(aux_gpu.loss.cpu(), aux_cpu.loss, rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(s_gpu.stats.max_radii.cpu(),
                               s_cpu.stats.max_radii, rtol=0, atol=1)
    for f in ("opacity_logit", "sh_dc"):  # first Adam step: lr·sign(g)
        m_gpu = getattr(s_gpu.adam.m, f).cpu()
        m_cpu = getattr(s_cpu.adam.m, f)
        err = (m_gpu - m_cpu).abs().max() / (m_cpu.abs().max() + 1e-12)
        assert err < 1e-3, (f, err)


def test_backward_wrappers_refuse_what_kernels_do_not_take(scene):
    g, cam = scene
    s = preprocess_cuda.preprocess_kernel(g, cam, tile=16)
    d = cs.splat_grads(P, g.capacity, np.random.default_rng(0))
    with pytest.raises(ValueError, match="CUDA"):
        preprocess_cuda.preprocess_bwd_kernel(g, cam, s.tiles_touched.cpu(), d)
    with pytest.raises(ValueError, match="shape"):
        preprocess_cuda.preprocess_bwd_kernel(
            g, cam, s.tiles_touched, d._replace(conic=d.conic[:, :2]))
    b = binning.bin_splats(s, W, H, 1 << 16, tile=16)
    _, st = blend_cuda.blend_train_kernel(b, s, W, H, 16)
    imgs = cs.image_grads(H, W, np.random.default_rng(0))
    with pytest.raises(ValueError, match="tiles"):
        blend_cuda.blend_bwd_kernel(b, s, st, *imgs, W, H, 8)
    with pytest.raises(ValueError, match="n_contrib"):
        blend_cuda.blend_bwd_kernel(b, s, st._replace(
            n_contrib=st.n_contrib.float()), *imgs, W, H, 16)
