"""The port's CUDA kernels against their plain versions, on the card.

Covers what ``chip_smoke.py``'s main path does not launch: the kernel
options (override color, SH degree, scaling modifier, inactive splats),
empty and fully culled views, an overflowing budget, kernel 2's edge
cases, kernel 3's two entries on thin and saturated splats (the
training entry's images bit-equal to the novel-view entry's, its
n_contrib the plain blend's last blended duplicate), ``render``'s normal
pass, and the wrappers' refusals; and for the training path, the
backward kernels under those options, the differentiable ``rasterize``
and one ``train_step`` against the CPU path; for object removal, LaMa
and ``inpaint_loss``'s gradients against the CPU; for SuGaR, a plain and
a regularized coarse step and the level set against the CPU.  The
tolerances are ``chip_smoke.py``'s.

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
    binning, blend_cuda, blend_ref, fill_cuda, preprocess_cuda, projection,
)
from autovfx_tpu_torch.utils.synthetic import make_garden_like, make_gaussians

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
                             fx=150.0, fy=150.0, width=W, height=H,
                             device="cpu")
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


@pytest.mark.parametrize("case", cs.DUPLICATE_CASES)
def test_duplicates_at_edge_cases(dev, case):
    cs.check_duplicate_args(P, cs.duplicate_case(case, dev), case)


def thin_conics(n: int, device) -> torch.Tensor:
    """Conics of splats one pixel row tall (even ids) or one column wide
    (odd ids): 40 across them, alpha >= 1/255 within ~0.5 px, and 0.04
    along."""
    row = torch.arange(n, device=device) % 2 == 0
    wide, thin = 0.04, 40.0  # sigma 5 px along, 0.16 px across
    return torch.stack([torch.where(row, wide, thin),
                        torch.zeros(n, device=device),
                        torch.where(row, thin, wide)], dim=1)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("kind", ["thin", "saturated"])
def test_blend_entries_match_plain(scene, tile, kind):
    """Both kernel-3 entries against the plain blend; the training
    entry's images bit-equal to the novel-view entry's, its final T the
    complement of alpha and its n_contrib the plain blend's last blended
    duplicate wherever the two cannot decide a duplicate otherwise."""
    g, cam = scene
    if kind == "saturated":
        g = with_fields(g, opacity_logit=torch.full_like(
            g.opacity_logit, cs.SATURATED_LOGIT))
    s = preprocess_cuda.preprocess_kernel(g, cam, tile=tile)
    if kind == "thin":
        s = s._replace(conic=thin_conics(g.capacity, g.xyz.device))
    budget = binning.round_budget(int(binning.required_budget(s)))
    b = binning.bin_splats(s, W, H, budget, tile=tile)
    images = blend_cuda.blend_kernel(b, s, W, H, tile)
    tiles = torch.arange(b.tile_range.shape[0], device=g.xyz.device)
    cs.check_blend(P, b, s, images, tiles, W, H, tile, f"{kind} tile {tile}")
    train_images, state = blend_cuda.blend_train_kernel(b, s, W, H, tile)
    for x, y in zip(train_images, images):
        assert torch.equal(x, y)
    assert torch.equal(1.0 - state.final_t, images[2])
    tx, ty = b.num_tiles_x, b.num_tiles_y
    image = lambda x: blend_ref.assemble_image(x, tx, ty, W, H, tile)
    want = image(blend_ref.last_blended(b, s, tile))
    marked = image(blend_ref.ambiguous_pixels(b, s, tile))
    assert float(marked.double().mean()) <= cs.MAX_AMBIGUOUS_SHARE
    assert int((want > 0).sum()) > W * H // 2
    assert not bool(((state.n_contrib != want) & ~marked).any())


def test_wrappers_refuse_what_kernels_do_not_take(scene):
    g, cam = scene
    cam_cpu = look_at_camera([2.6, 0.4, 1.2], [0, 0, 0.2], [0, 0, 1],
                             fx=150.0, fy=150.0, width=W, height=H,
                             device="cpu")
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


@pytest.mark.parametrize("sh_degree, n, degree", [
    (0, 1000, None), (1, 1037, None), (1, 1037, 0), (2, 777, 1),
    (3, 1283, None), (3, 1283, 1), (4, 300, None), (4, 300, 2),
])
def test_preprocess_bwd_sh_rows_and_ragged_blocks(scene, sh_degree, n,
                                                  degree):
    """Stored SH degrees 0-4 (SH rest rows of 0, 3, 8, 15 and 24
    coefficients: 24 needs more than 48 KB of shared memory), evaluated at
    the stored degree or below it, over slot counts that leave the last
    block of 128 splats ragged."""
    _, cam = scene
    dev = cam.R.device
    g = make_gaussians(n, np.random.default_rng(n), spread=0.8,
                       sh_degree=sh_degree, device=dev)
    kw = {} if degree is None else {"sh_degree": degree}
    s = projection.preprocess(g, cam, tile=16, **kw)
    assert int((s.tiles_touched > 0).sum()) > n // 4  # most are in view
    d = cs.splat_grads(P, n, np.random.default_rng(n + 1))
    got = preprocess_cuda.preprocess_bwd_kernel(g, cam, s.tiles_touched, d,
                                                **kw)
    want = preprocess_cuda.preprocess_bwd_plain(g, cam, s.tiles_touched, d,
                                                **kw)
    cs.check_fields(got, want, cs.PRE_BWD_TOL,
                    f"stored degree {sh_degree}, {n} slots, {kw}")


def test_preprocess_bwd_reads_column_slices_as_copies(scene):
    """The output gradients as column slices of one (N, 10) buffer (kernel
    4's rows) and as contiguous copies give the same parameter
    gradients, bit for bit."""
    g, cam = scene
    s = projection.preprocess(g, cam, tile=16)
    d = cs.splat_grads(P, g.capacity, np.random.default_rng(11))
    assert d.conic.stride() == (10, 1) and d.opacity.stride() == (10,)
    sliced = preprocess_cuda.preprocess_bwd_kernel(g, cam, s.tiles_touched, d)
    copied = preprocess_cuda.preprocess_bwd_kernel(
        g, cam, s.tiles_touched, type(d)(*(x.contiguous() for x in d)))
    for a, b in zip(sliced[:6], copied[:6]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("logit", [None, cs.SATURATED_LOGIT])
def test_blend_bwd_matches_plain(scene, tile, logit):
    g, cam = scene
    if logit is not None:
        g = with_fields(g, opacity_logit=torch.full_like(g.opacity_logit,
                                                         logit))
    cs.check_blend_bwd(P, g, cam, tile, np.random.default_rng(7),
                       f"tile {tile} logit {logit}")


@pytest.mark.parametrize("tile", [16, 32])
def test_blend_bwd_thin_splats(scene, tile):
    """Splats one pixel row tall or one column wide (conics of 40 across
    them: alpha >= 1/255 within ~0.5 px), so each crosses the warps'
    patches along one side only."""
    g, cam = scene
    s = preprocess_cuda.preprocess_kernel(g, cam, tile=tile)
    s = s._replace(conic=thin_conics(g.capacity, g.xyz.device))
    budget = binning.round_budget(int(binning.required_budget(s)))
    b = binning.bin_splats(s, W, H, budget, tile=tile)
    cs.check_blend_bwd_binned(P, b, s, W, H, tile, np.random.default_rng(12),
                              f"thin splats, tile {tile}")


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


# ---- the edited frame ---------------------------------------------------------


def test_preprocess_writes_rows_of_a_caller_buffer(dev, scene):
    """Kernel 1 into row slices of one buffer gives the rows it returns
    on its own, and refuses a buffer of the wrong shape or device."""
    from autovfx_tpu_torch.ops.projection import empty_splats

    g, cam = scene
    buf = empty_splats(g.capacity + 100, dev)
    rows = projection.Splats2D(*(x[100:] for x in buf))
    got = preprocess_cuda.preprocess_kernel(g, cam, tile=16, out=rows)
    want = preprocess_cuda.preprocess_kernel(g, cam, tile=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    short = projection.Splats2D(*(x[101:] for x in buf))
    with pytest.raises(ValueError, match="shape"):
        preprocess_cuda.preprocess_kernel(g, cam, tile=16, out=short)


def test_rasterize_multi_on_the_card(dev, scene):
    """The merged render of two sets equals ``rasterize`` of their
    concatenation bit for bit, and the CPU path's image within the
    novel view's budget."""
    from autovfx_tpu_torch.core.gaussians import merge

    g, cam = scene
    g2 = make_gaussians(800, np.random.default_rng(4), spread=0.4,
                        device=dev)
    cfg = P.RasterConfig(dup_budget=1 << 17, tile=16)
    a = P.rasterize_multi([g, g2], cam, config=cfg)
    b = P.rasterize(merge(g, g2), cam, config=cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    to_cpu = lambda x: dataclasses.replace(x, **{
        f.name: getattr(x, f.name).cpu() for f in dataclasses.fields(x)
        if torch.is_tensor(getattr(x, f.name))})
    c = P.rasterize_multi([to_cpu(g), to_cpu(g2)], to_cpu(cam), config=cfg)
    assert cs.psnr(a.color.cpu(), c.color) > cs.BLEND_PSNR_DB


def test_physics_on_the_card_matches_the_cpu(dev):
    """The bench's cube drop on the card against the same solver on the
    CPU: centers of mass within 1e-3 m over 8 frames; two card runs
    bit-equal."""
    from autovfx_tpu_torch.physics import world

    def drop(device):
        saved = cs.DEVICE
        cs.DEVICE = device
        try:
            return cs.cube_world(P)[0]
        finally:
            cs.DEVICE = saved

    card, cpu = drop("cuda"), drop("cpu")
    _, p1, q1 = world.simulate(card, 8)
    _, p2, q2 = world.simulate(card, 8)
    assert np.array_equal(p1, p2) and np.array_equal(q1, q2)
    _, pc, _ = world.simulate(cpu, 8)
    assert np.abs(p1 - pc).max() <= 1e-3


# ---- float32 convolutions under PyTorch's default TF32 flags -----------------
# These tests set no flag: cuDNN may run float32 convolutions in TF32 by
# default, and the package's own must not.


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def test_compute_loss_under_default_flags_matches_cpu(scene):
    """``compute_loss`` on the card against the CPU's photometric loss of
    the image the card rendered, at the JAX loss tests' rtol 1e-5; and
    the loss's image gradient (the SSIM window's convolutions backward)
    within 1e-5 of its largest.  The flags are left as they were."""
    from autovfx_tpu_torch.train import losses as L
    from autovfx_tpu_torch.train import trainer as T

    g, cam = scene
    before = _flags()
    cfg = T.TrainConfig(raster=P.RasterConfig(dup_budget=1 << 16, tile=16))
    target = torch.from_numpy(
        np.random.default_rng(11).random((H, W, 3), np.float32))
    loss, _ = T.compute_loss(g, torch.zeros((g.capacity, 2), device="cuda"),
                             cam, target.cuda(), cfg)
    image = P.rasterize(g, cam, bg=torch.zeros(3, device="cuda"),
                        config=cfg.raster).color
    want = L.photometric_loss(image.cpu(), target, cfg.lambda_dssim)
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=0)
    grads = []
    for dev in ("cuda", "cpu"):
        x = image.detach().to(dev).requires_grad_(True)
        L.photometric_loss(x, target.to(dev), cfg.lambda_dssim).backward()
        grads.append(x.grad.cpu())
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert err < 1e-5, err
    assert _flags() == before


def test_lpips_under_default_flags_matches_cpu():
    """``lpips_distance`` of two 128×128 images on the card against the
    CPU at the LPIPS tests' rtol 1e-4, and its input gradient within 1e-3
    of the largest; the flags are left as they were."""
    from autovfx_tpu_torch.utils import lpips

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    before = _flags()
    rng = np.random.default_rng(12)
    a, b = (torch.from_numpy(rng.random((128, 128, 3), np.float32))
            for _ in range(2))
    out = {}
    for dev in ("cuda", "cpu"):
        x = a.to(dev).requires_grad_(True)
        d = lpips.lpips_distance(x, b.to(dev))
        d.backward()
        out[dev] = (d.item(), x.grad.cpu())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * out["cpu"][0]
    g_card, g_cpu = out["cuda"][1], out["cpu"][1]
    assert ((g_card - g_cpu).abs().max() / g_cpu.abs().max()) < 1e-3
    assert _flags() == before


# ---- the edited frame's stages after the render, card against CPU --------------
# On the port's rendition of tests/test_clip_fused.py's 96×64 scene (a
# 400-splat ground carpet, a 3,000-surfel cube falling through two frames,
# tile 16, an 8-light seeded envmap), with a 12³ smoke/fire volume and
# melt tracers for the effects frame.  The bounds are the CPU tests':
# shadow ratio within 1e-5 and hull weight equal on ≥ 99.9 % of pixels
# (tests/test_torch_render.py), frames within 1e-4 on ≥ 99.5 % of pixels
# with a mean difference ≤ 1e-3 (tests/test_torch_clip_multipass.py).
AGREE, FRAME_AGREE = 0.999, 0.995


def _to(x, dev):
    """A dataclass of tensors (nested ones too) on ``dev``."""
    fields = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if torch.is_tensor(v):
            v = v.to(dev)
        elif dataclasses.is_dataclass(v):
            v = _to(v, dev)
        fields[f.name] = v
    return dataclasses.replace(x, **fields)


def _edit_clip(frames=2):
    """The clip's inputs on the CPU, plain and with effects."""
    from autovfx_tpu_torch.core.cameras import stack_cameras
    from autovfx_tpu_torch.physics.shapes import build_hulls
    from autovfx_tpu_torch.render import clip, meshsplat, smoke

    g = make_gaussians(400, np.random.default_rng(0), spread=1.0,
                       device="cpu")
    xyz = g.xyz.clone()
    xyz[:, 2] = xyz[:, 2].abs() * 0.02 - 0.4
    g = dataclasses.replace(g, xyz=xyz)
    cams = stack_cameras([
        look_at_camera([2.2 * np.cos(a), 2.2 * np.sin(a), 1.2], [0, 0, 0.0],
                       [0, 0, 1], fx=80.0, fy=80.0, width=96, height=64,
                       device="cpu")
        for a in np.linspace(0.0, 0.6, frames)])
    corners = np.array([[x, y, z] for x in (-0.25, 0.25)
                        for y in (-0.25, 0.25) for z in (-0.25, 0.25)],
                       np.float32)
    hull, _, _, _ = build_hulls([corners], device="cpu")
    surf = meshsplat.sample_mesh_surfels(corners, cs.CUBE_FACES,
                                         num_samples=3000, device="cpu")
    zs = np.linspace(0.6, 0.3, frames)
    traj_pos = np.stack([np.stack([np.zeros(frames), np.zeros(frames), zs],
                                  -1)], 1).astype(np.float32)
    traj_rot = np.tile(np.eye(3, dtype=np.float32), (frames, 1, 1, 1))
    env = (0.3 + 0.7 * np.random.RandomState(1).rand(16, 32, 3)).astype(
        np.float32)
    s_cfg = smoke.SmokeConfig(resolution=12, jacobi_iters=5, with_fire=True)
    states = smoke.simulate_smoke(
        s_cfg, smoke.sphere_inflow(s_cfg, [6, 6, 2], 2.0, device="cpu"),
        frames)
    n = surf["points"].shape[0]
    base = surf["points"].numpy() + np.array([0, 0, 0.3])
    melt = dict(pos=np.stack([base * (1.0 - 0.3 * f / max(frames - 1, 1))
                              for f in range(frames)]).astype(np.float32),
                norm=np.tile(np.array([0, 0, 1.0], np.float32),
                             (frames, n, 1)),
                mask=np.ones(n, bool))
    kw = dict(bg=g, cams=cams,
              objects=[{"scale": 1.0, "material": {"rgb": [0.9, 0.1, 0.1]}}],
              surfels=[surf], traj_pos=traj_pos, traj_rot=traj_rot,
              hull_shape=hull, env=env, num_lights=8, device="cpu")
    plain = clip.build_clip_inputs(**kw)
    effects = clip.build_clip_inputs(
        smoke_traj=(states, np.array([-0.6, -0.6, -0.3], np.float32), 1.2,
                    s_cfg), melt=melt, **kw)
    return plain, effects, s_cfg, P.RasterConfig(dup_budget=1 << 15, tile=16)


@pytest.fixture(scope="module")
def edit_clip(dev):
    plain, effects, s_cfg, cfg = _edit_clip()
    return {"cpu": (plain, effects), "cuda": (_to(plain, dev),
                                              _to(effects, dev)),
            "smoke_cfg": s_cfg, "config": cfg}


def _frames_agree(got, want):
    d = (got.cpu() - want).abs().amax(dim=-1)
    assert (d <= 1e-4).double().mean().item() >= FRAME_AGREE, d.max()
    assert d.mean().item() <= 1e-3


def _merged(inp, cfg):
    """The fused frame's merged render and the inputs of its stages."""
    from autovfx_tpu_torch.core.cameras import index_camera
    from autovfx_tpu_torch.render import clip

    cam = index_camera(inp.cams, 0)
    out = P.rasterize_multi([inp.bg, clip.shaded_object_gaussians(inp, 0,
                                                                  cam)],
                            cam, config=cfg)
    return cam, out, clip.world_hull_planes_at(inp, 0)


@pytest.mark.parametrize("scale", [1, 2])
def test_shadow_ratio_map_on_the_card(edit_clip, scale):
    """The same depth and alpha (the CPU's merged render) on both."""
    from autovfx_tpu_torch.render import shadow

    res = {}
    cpu_cam, out, _ = _merged(edit_clip["cpu"][0], edit_clip["config"])
    for dev in ("cuda", "cpu"):
        inp = edit_clip[dev][0]
        cam, planes = (_to(cpu_cam, dev),
                       _merged(inp, edit_clip["config"])[2])
        a = out.alpha.clamp(0.0, 1.0).to(dev)
        res[dev] = shadow.shadow_ratio_map(
            cam, out.depth.to(dev), a.clamp(min=1e-3), inp.light_dirs,
            inp.light_weights, planes, inp.hull_mask, scale=scale).cpu()
    assert ((res["cuda"] - res["cpu"]).abs() <= 1e-5).double().mean() >= AGREE
    assert res["cpu"].min() < 0.99  # some shadow in view


def test_hull_object_weight_on_the_card(edit_clip):
    from autovfx_tpu_torch.render import clip, shadow

    cpu_cam, out, _ = _merged(edit_clip["cpu"][0], edit_clip["config"])
    depth = clip.pass_depth(out, out.alpha.clamp(0.0, 1.0))
    res = {}
    for dev in ("cuda", "cpu"):
        inp = edit_clip[dev][0]
        res[dev] = shadow.hull_object_weight(
            _to(cpu_cam, dev), depth.to(dev),
            _merged(inp, edit_clip["config"])[2], inp.hull_mask,
            pad=clip.object_pad(inp)).cpu()
    assert (res["cuda"] == res["cpu"]).double().mean() >= AGREE
    assert 0.0 < res["cpu"].mean() < 1.0


@pytest.mark.parametrize("path", ["fused", "multipass", "effects"])
def test_edited_frame_on_the_card(edit_clip, path):
    from autovfx_tpu_torch.render import clip

    cfg = edit_clip["config"]
    frames = {}
    for dev in ("cuda", "cpu"):
        plain, effects = edit_clip[dev]
        if path == "fused":
            frames[dev] = clip.render_edited_frame_fused(plain, 1, cfg)
        elif path == "multipass":
            frames[dev] = clip.render_edited_frame(plain, 1, cfg)
        else:
            frames[dev] = clip.render_edited_frame_fused(
                effects, 1, cfg, smoke_cfg=edit_clip["smoke_cfg"])
    assert bool(torch.isfinite(frames["cuda"]).all())
    _frames_agree(frames["cuda"], frames["cpu"])


def test_render_clip_supersampled_on_the_card(edit_clip):
    from autovfx_tpu_torch.render import clip

    frames = {dev: clip.render_clip(edit_clip[dev][0], 2,
                                    edit_clip["config"], fused=True,
                                    supersample=2)
              for dev in ("cuda", "cpu")}
    assert frames["cuda"].shape == (2, 64, 96, 3)
    _frames_agree(frames["cuda"], frames["cpu"])


def test_effects_cases_on_the_card_match_the_cpu(dev):
    """chip_smoke's card-against-CPU cases of the smoke, melt, LPIPS and
    LaMa."""
    err = cs.card_against_cpu(P)
    assert set(err) == {"smoke fixed", "smoke adaptive", "melt", "lpips",
                        "lama"}


# ---- the edit layer ----------------------------------------------------------
# tests/test_torch_edit.py's drop edit and tests/test_torch_extract.py's
# extraction, made from files that the port writes, on the card and on the
# CPU: the frames to the multi-pass bound, the same triangles and splats.

CUBE = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                 for z in (-0.5, 0.5)], np.float32)


def _edit_files(root, extraction=False):
    """Splats, scene mesh and a 4-camera 64×48 ring as files: the drop
    scene (a flat cloud over a ground quad), or with ``extraction`` a
    box standing on it with 150 of the splats inside (the masks' object,
    rows 300 on)."""
    import os

    from autovfx_tpu_torch.core import cameras, ply_io
    from autovfx_tpu_torch.core.gaussians import merge
    from autovfx_tpu_torch.edit import mesh_io

    ground = make_gaussians(300 if extraction else 400,
                            np.random.default_rng(0), spread=1.5,
                            device="cpu")
    xyz = ground.xyz.clone()
    xyz[:, 2] = xyz[:, 2].abs() * 0.02
    g = dataclasses.replace(ground, xyz=xyz)
    gv = np.array([[-6, -6, 0], [6, -6, 0], [6, 6, 0], [-6, 6, 0]],
                  np.float32)
    gf = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    v, f = gv, gf
    if extraction:
        box = make_gaussians(150, np.random.default_rng(1), spread=0.22,
                             device="cpu")
        g = merge(g, dataclasses.replace(
            box, xyz=box.xyz + torch.tensor([0.0, 0.0, 0.5])))
        v = np.concatenate([gv, CUBE + [0, 0, 0.5]])
        f = np.concatenate([gf, cs.CUBE_FACES + 4])
    ply_io.save_ply(os.path.join(root, "scene.ply"), g)
    mesh_io.save_obj(os.path.join(root, "scene_mesh.obj"),
                     mesh_io.Mesh(v.astype(np.float32), f))
    mesh_io.save_obj(os.path.join(root, "cube.obj"),
                     mesh_io.Mesh(CUBE, cs.CUBE_FACES))
    cams = cameras.stack_cameras([
        look_at_camera([2.6 * np.cos(a), 2.6 * np.sin(a), 1.6],
                       [0, 0, 0.4], [0, 0, 1], fx=60.0, fy=60.0, width=64,
                       height=48, device="cpu")
        for a in np.linspace(0, np.pi / 2, 4)])
    cameras.save_custom_trajectory(
        os.path.join(root, "custom_camera_path", "ring.json"), cams)
    return g, cams, dict(
        source_path=root, gaussians_ckpt_path=os.path.join(root, "scene.ply"),
        scene_mesh_path=os.path.join(root, "scene_mesh.obj"),
        custom_traj_name="ring", dup_budget=1 << 18, light_samples=8)


def _scenes(root, params):
    import os

    from autovfx_tpu_torch.edit.scene_representation import (
        SceneParams, SceneRepresentation)

    return {dev: SceneRepresentation(SceneParams(
        cache_dir=os.path.join(root, dev), device=dev, **params))
        for dev in ("cuda", "cpu")}


def test_drop_edit_on_the_card_matches_the_cpu(dev, tmp_path):
    import os

    from autovfx_tpu_torch.edit import edit_utils as EU
    from autovfx_tpu_torch.edit.edit_ir import default_object_info

    _, _, params = _edit_files(str(tmp_path))
    scenes = _scenes(str(tmp_path), params)
    frames = {}
    for d, scene in scenes.items():
        obj = default_object_info()
        obj.update(object_id="cube", object_name="cube",
                   object_path=os.path.join(str(tmp_path), "cube.obj"),
                   pos=np.array([0.0, 0.0, 1.2], np.float32), scale=0.3)
        EU.insert_object(scene, EU.allow_physics(obj))
        frames[d] = scene.render_scene()
        assert frames[d].device.type == d and not bool(scene.overflowed)
    for i in range(4):
        _frames_agree(frames["cuda"][i], frames["cpu"][i])
    rb = {d: s.rb_transform["cube"] for d, s in scenes.items()}
    for f in rb["cpu"]:
        assert np.abs(np.subtract(rb["cuda"][f]["pos"],
                                  rb["cpu"][f]["pos"])).max() < 1e-3


def test_extraction_on_the_card_matches_the_cpu(dev, tmp_path):
    import os

    from autovfx_tpu_torch.core.cameras import index_camera
    from autovfx_tpu_torch.edit import mesh_io
    from autovfx_tpu_torch.perception import extract
    from autovfx_tpu_torch.utils import png

    g, cams, params = _edit_files(str(tmp_path), extraction=True)
    scenes = _scenes(str(tmp_path), params)
    box = dataclasses.replace(g, active=torch.arange(g.capacity) >= 300)
    paths = {}
    for d, scene in scenes.items():
        tdir = os.path.join(scene.tracking_results_dir, "box", "1")
        os.makedirs(tdir)
        for i in range(4):
            alpha = P.rasterize(box, index_camera(cams, i),
                                config=P.RasterConfig(1 << 14)).alpha
            png.write_png(os.path.join(tdir, f"{i:05d}.png"),
                          (alpha.numpy() > 0.4).astype(np.uint8) * 255)
        paths[d] = extract.extract_object_from_scene(scene, "box", 1)
    base = {d: os.path.dirname(os.path.dirname(p)) for d, p in paths.items()}
    got, want = (mesh_io.load_mesh(paths[d]) for d in ("cuda", "cpu"))
    assert len(want.faces) > 0
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    for name in ("object_gaussians.ply", "removal_gaussians.ply"):
        with open(os.path.join(base["cuda"], name), "rb") as a, \
                open(os.path.join(base["cpu"], name), "rb") as b:
            assert a.read() == b.read(), name


# ---- object removal -------------------------------------------------------------


def test_lama_on_the_card_matches_the_cpu(dev):
    """A tiny seeded LaMa (ngf 8, 2 downsamples, 2 blocks) on an image
    whose 1/4 width is odd: the generator on the card within 1e-4 of the
    CPU's output range, ``inpaint_with_params`` within 1 in 8 bits and
    exact outside the hole; cuDNN's TF32 flag left at PyTorch's
    default."""
    from autovfx_tpu_torch.perception import lama
    from autovfx_tpu_torch.utils.synthetic import lama_state_dict

    before = _flags()
    sd = lama_state_dict(ngf=8, n_down=2, n_blocks=2, seed=4)
    params = {d: lama.convert_torch_state_dict(sd, device=d)
              for d in ("cuda", "cpu")}
    x = torch.from_numpy(np.random.default_rng(13).normal(
        0, 1, (1, 4, 40, 72)).astype(np.float32))
    out = {d: lama.lama_generator(p, x.to(d)).cpu() for d, p in params.items()}
    span = (out["cpu"].max() - out["cpu"].min()).item()
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= 1e-4 * span
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (40, 72, 3), dtype=np.uint8)
    mask = np.zeros((40, 72), bool)
    mask[8:30, 20:50] = True
    got, want = (lama.inpaint_with_params(params[d], img, mask, device=d)
                 for d in ("cuda", "cpu"))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got[~mask] == want[~mask]).all()
    assert _flags() == before


@pytest.mark.parametrize("use_lpips", [False, True])
def test_inpaint_loss_gradients_match_cpu(scene, use_lpips):
    """``inpaint_loss`` and its gradients through the kernels against the
    CPU path's, per field within 1e-3 of its largest magnitude (the
    differentiable rasterize's budget above), the loss at rtol 1e-4; the
    flags left at PyTorch's defaults."""
    from autovfx_tpu_torch.train import inpaint_retrain as IR
    from autovfx_tpu_torch.train import trainer as T

    g, cam = scene
    before = _flags()
    cfg = T.TrainConfig(raster=P.RasterConfig(dup_budget=1 << 16))
    rng = np.random.default_rng(15)
    target = torch.from_numpy(rng.random((H, W, 3), np.float32))
    mask = torch.zeros((H, W), dtype=torch.bool)
    mask[20:100, 40:160] = True
    out = {}
    for d, gg, cc in (("cuda", g, cam), ("cpu", _cpu(g), _cpu(cam))):
        leaves = {f: getattr(gg, f).clone().requires_grad_(True)
                  for f in PARAM_FIELDS}
        off = torch.zeros((gg.capacity, 2), device=d, requires_grad=True)
        loss, _ = IR.inpaint_loss(dataclasses.replace(gg, **leaves), off, cc,
                                  target.to(d), mask.to(d), cfg, use_lpips)
        loss.backward()
        out[d] = (loss.item(), {f: v.grad.cpu() for f, v in leaves.items()})
        out[d][1]["mean2d_offset"] = off.grad.cpu()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for f, want in out["cpu"][1].items():
        got = out["cuda"][1][f]
        err = (got - want).abs().max().item() / (want.abs().max().item()
                                                 + 1e-12)
        assert err < 1e-3, (f, err)
    assert _flags() == before


def test_sugar_coarse_steps_match_cpu(dev):
    """Losses at rtol 1e-5, every field after Adam within 5e-4 of its
    largest (``chip_smoke.sugar_card_against_cpu``'s bounds)."""
    s_g, l_g, _ = cs.sugar_shell_case(P, "cuda")
    s_c, l_c, _ = cs.sugar_shell_case(P, "cpu")
    for got, want in zip(l_g, l_c):
        assert abs(got - want) <= cs.LOSS_RTOL * abs(want)
    for f in PARAM_FIELDS:
        want = getattr(s_c.gaussians, f)
        err = (getattr(s_g.gaussians, f).cpu() - want).abs().max().item()
        assert err <= cs.STATE_TOL * want.abs().max().item(), f


def test_sugar_level_set_matches_cpu(dev):
    """Valid masks agree on ≥ 99.5 % of the rays, points within 1e-4 on
    the rays valid in both."""
    _, _, ls_g = cs.sugar_shell_case(P, "cuda")
    _, _, ls_c = cs.sugar_shell_case(P, "cpu")
    v_g, v_c = ls_g.valid.cpu().numpy(), ls_c.valid.numpy()
    assert (v_g == v_c).mean() >= cs.LEVEL_AGREE
    both = v_g & v_c
    assert both.sum() > 100
    err = np.abs(ls_g.points.cpu().numpy()[both] - ls_c.points.numpy()[both])
    assert float(err.max()) <= cs.LEVEL_POINT_TOL


def test_one_nccl_rank_matches_the_single_device_paths(scene, tmp_path):
    """A world of one NCCL rank: ``dp_train_step`` against
    ``train_step`` (the forward's loss, PSNR and densify counts equal;
    the backward sums with atomics in no fixed order, so the state is
    held to ``chip_smoke``'s 5e-4 of each field's largest), and the three
    slab paths at D = 1 against ``rasterize`` (color and depth equal,
    alpha = 1 - (1 - alpha) within float32 rounding)."""
    import torch.distributed as dist

    from autovfx_tpu_torch.parallel import make_mesh
    from autovfx_tpu_torch.parallel import sharding as S
    from autovfx_tpu_torch.train import trainer as T

    g, cam = scene
    cfg = T.TrainConfig(raster=P.RasterConfig(dup_budget=1 << 16, tile=16),
                        spatial_lr_scale=2.67)
    target = torch.from_numpy(
        np.random.default_rng(11).random((H, W, 3), np.float32)).cuda()
    bg = torch.tensor([0.3, 0.2, 0.1], device="cuda")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), backend="nccl", device="cuda")
        s_dp, a_dp = S.dp_train_step(T.init_state(g), cam, target, cfg, mesh)
        s_seq, a_seq = T.train_step(T.init_state(g), cam, target, cfg)
        assert torch.equal(a_dp.loss, a_seq.loss)
        assert torch.equal(a_dp.psnr, a_seq.psnr)
        assert torch.equal(s_dp.stats.denom, s_seq.stats.denom)
        assert torch.equal(s_dp.stats.max_radii, s_seq.stats.max_radii)
        for f in PARAM_FIELDS:
            want = getattr(s_seq.gaussians, f)
            err = (getattr(s_dp.gaussians, f) - want).abs().max().item()
            assert err <= cs.STATE_TOL * want.abs().max().item(), f
        with torch.no_grad():
            ref = P.rasterize(g, cam, bg=bg,
                              config=P.RasterConfig(dup_budget=1 << 16))
            compact, ovf = S.shard_gaussians_compact(g, cam, 1, 0)
            assert not bool(ovf)
            built, ovf = S.distributed_shard_compact(
                S.round_robin_store(g, 1, 0), cam, mesh)
            assert not bool(ovf)
            outs = [S.sharded_render(S.shard_gaussians(g, cam, 1, 0), cam,
                                     mesh, P.RasterConfig(dup_budget=1 << 16),
                                     bg),
                    S.sharded_render_compact(compact, cam, mesh,
                                             P.RasterConfig(dup_budget=1 << 16),
                                             bg)]
            # the distributed build reorders the splats: the blend's sums
            # run in another order where depths tie
            dist_out = S.sharded_render_compact(
                built, cam, mesh, P.RasterConfig(dup_budget=1 << 16), bg)
        for color, depth, alpha in outs:
            assert torch.equal(color, ref.color)
            assert torch.equal(depth, ref.depth)
            assert (alpha - ref.alpha).abs().max().item() <= 1.2e-7
        for got, want in zip(dist_out, (ref.color, ref.depth, ref.alpha)):
            assert (got - want).abs().max().item() <= 1e-5
    finally:
        dist.destroy_process_group()
