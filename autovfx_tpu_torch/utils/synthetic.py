"""Procedural test scenes made from a seeded numpy generator.

Counterpart of ``autovfx_tpu/utils/synthetic.py``: the same shapes and
distributions (SH degree 3, a flat ground disc, mid-height clutter and a
far shell), but numpy's random numbers, so a scene made here is not the
one the JAX package makes from the same seed.  To compare the two
packages on one scene, build it there and carry it over with
``autovfx_tpu_torch.convert``.
"""
from __future__ import annotations

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.cameras import Camera, look_at_camera
from autovfx_tpu_torch.core.gaussians import Gaussians, merge


def make_gaussians(
    n: int,
    rng: np.random.Generator,
    spread: float = 1.0,
    scale_range: tuple[float, float] = (0.01, 0.08),
    sh_degree: int = 3,
    opacity_range: tuple[float, float] = (0.2, 0.95),
    device=devices.DEFAULT,
) -> Gaussians:
    device = devices.resolve(device)
    f32 = np.float32
    xyz = rng.standard_normal((n, 3), dtype=f32) * f32(spread)
    rgb = rng.random((n, 3), dtype=f32)
    k = (sh_degree + 1) ** 2
    sh_rest = f32(0.05) * rng.standard_normal((n, k - 1, 3), dtype=f32)
    lo, hi = scale_range
    log_s = np.log(rng.uniform(lo, hi, (n, 3)).astype(f32))
    quats = rng.standard_normal((n, 4), dtype=f32)
    quats /= np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    op = rng.uniform(*opacity_range, n).astype(f32)
    c0 = f32(0.28209479177387814)
    t = lambda a: torch.from_numpy(a).to(device)
    return Gaussians(
        xyz=t(xyz),
        sh_dc=t((rgb - f32(0.5)) / c0),
        sh_rest=t(sh_rest),
        log_scales=t(log_s),
        quats=t(quats),
        opacity_logit=t(np.log(op / (1 - op))),
        active=torch.ones(n, dtype=torch.bool, device=device),
    )


def make_scene(
    n: int = 1000,
    width: int = 64,
    height: int = 48,
    seed: int = 0,
    fx: float | None = None,
    cam_dist: float = 4.0,
    device=devices.DEFAULT,
) -> tuple[Gaussians, Camera]:
    """``n`` Gaussians of ``make_gaussians`` (drawn from
    ``default_rng(seed)``) and a camera ``cam_dist`` from the origin
    looking at it (focal 0.9 × ``width`` unless given)."""
    device = devices.resolve(device)
    g = make_gaussians(n, np.random.default_rng(seed), device=device)
    if fx is None:
        fx = 0.9 * width
    cam = look_at_camera(
        eye=[cam_dist, 0.6, 0.8],
        target=[0.0, 0.0, 0.0],
        up=[0.0, 0.0, 1.0],
        fx=fx,
        fy=fx,
        width=width,
        height=height,
        device=device,
    )
    return g, cam


def make_garden_like(
    n: int = 3_000_000, seed: int = 0, extent: float = 3.0,
    device=devices.DEFAULT,
) -> Gaussians:
    """A Garden-scale splat cloud: dense ground disc + clutter + far shell."""
    device = devices.resolve(device)
    rng = np.random.default_rng(seed)
    n_ground = n // 2
    n_mid = n // 3
    n_far = n - n_ground - n_mid
    g_ground = make_gaussians(n_ground, rng, spread=extent,
                              scale_range=(0.004, 0.02), device=device)
    g_ground.xyz[:, 2] *= 0.02  # in place: the tensor is this function's own
    g_mid = make_gaussians(n_mid, rng, spread=extent * 0.5,
                           scale_range=(0.004, 0.03), device=device)
    g_mid.xyz[:, 2] += 0.5
    g_far = make_gaussians(n_far, rng, spread=extent * 3.0,
                           scale_range=(0.05, 0.2), device=device)
    return merge(merge(g_ground, g_mid), g_far)


def garden_camera(width: int = 1296, height: int = 840,
                  device=devices.DEFAULT) -> Camera:
    """The Garden demo intrinsics at ``width`` x ``height``."""
    scale = width / 1296.0
    return look_at_camera(
        eye=[2.2, 1.2, 1.6],
        target=[0.0, 0.0, 0.2],
        up=[0.0, 0.0, 1.0],
        fx=960.98 * scale,
        fy=963.15 * scale,
        width=width,
        height=height,
        device=device,
    )


def lama_state_dict(ngf: int = 64, n_down: int = 3, n_blocks: int = 18,
                    ratio: float = 0.75, seed: int = 0) -> dict:
    """A seeded LaMa generator checkpoint's ``state_dict`` (CPU tensors
    named ``generator.model.{i}.*``) at the given widths; the defaults
    are big-lama's (``configs/training/big-lama.yaml``).  The layout is
    FFCResNetGenerator's Sequential: a 7x7 stem, ``n_down`` stride-2
    FFCs (the last opens the global branch at ``ratio``), ``n_blocks``
    residual FFC blocks, ``n_down`` (transposed conv, BatchNorm, ReLU)
    triples and a 7x7 output convolution.  Convolution weights are
    normal with std 0.2 / (k·sqrt(in)) and the BatchNorms near identity,
    so activations stay finite through the 18 blocks; the weights stand
    in for the released ones, which are not in the repository."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    sd = {}

    def bn(prefix, c):
        sd[prefix + ".weight"] = rng.normal(1.0, 0.1, c).astype(f32)
        sd[prefix + ".bias"] = rng.normal(0.0, 0.1, c).astype(f32)
        sd[prefix + ".running_mean"] = rng.normal(0.0, 0.3, c).astype(f32)
        sd[prefix + ".running_var"] = (0.5 + rng.random(c)).astype(f32)
        sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def conv(key, cout, cin, k):
        sd[key] = (rng.normal(0, 0.2, (cout, cin, k, k))
                   / (k * np.sqrt(cin))).astype(f32)

    def ffc(p, cin, cout, rin, rout, k):
        in_g, out_g = int(cin * rin), int(cout * rout)
        in_l, out_l = cin - in_g, cout - out_g
        if in_l and out_l:
            conv(f"{p}.ffc.convl2l.weight", out_l, in_l, k)
        if in_l and out_g:
            conv(f"{p}.ffc.convl2g.weight", out_g, in_l, k)
        if in_g and out_l:
            conv(f"{p}.ffc.convg2l.weight", out_l, in_g, k)
        if in_g and out_g:
            g = f"{p}.ffc.convg2g"
            conv(g + ".conv1.0.weight", out_g // 2, in_g, 1)
            bn(g + ".conv1.1", out_g // 2)
            conv(g + ".fu.conv_layer.weight", out_g, out_g, 1)
            bn(g + ".fu.bn", out_g)
            conv(g + ".conv2.weight", out_g, out_g // 2, 1)
        if out_l:
            bn(f"{p}.bn_l", out_l)
        if out_g:
            bn(f"{p}.bn_g", out_g)

    i = 1  # index 0 is the stem's ReflectionPad2d
    ffc(f"model.{i}", 4, ngf, 0.0, 0.0, 7)
    i += 1
    for d in range(n_down):
        ffc(f"model.{i}", ngf * 2**d, ngf * 2**(d + 1), 0.0,
            ratio if d == n_down - 1 else 0.0, 3)
        i += 1
    feat = ngf * 2**n_down
    for _ in range(n_blocks):
        ffc(f"model.{i}.conv1", feat, feat, ratio, ratio, 3)
        ffc(f"model.{i}.conv2", feat, feat, ratio, ratio, 3)
        i += 1
    i += 1  # ConcatTupleLayer
    for u in range(n_down):
        cin = ngf * 2**(n_down - u)
        sd[f"model.{i}.weight"] = (rng.normal(0, 0.2, (cin, cin // 2, 3, 3))
                                   / (3 * np.sqrt(cin))).astype(f32)
        sd[f"model.{i}.bias"] = rng.normal(0, 0.1, cin // 2).astype(f32)
        bn(f"model.{i + 1}", cin // 2)
        i += 3  # ConvTranspose2d, BatchNorm2d, ReLU
    i += 1  # ReflectionPad2d
    conv(f"model.{i}.weight", 3, ngf, 7)
    sd[f"model.{i}.bias"] = rng.normal(0, 0.1, 3).astype(f32)
    return {"generator." + k: torch.from_numpy(np.asarray(v))
            for k, v in sd.items()}
