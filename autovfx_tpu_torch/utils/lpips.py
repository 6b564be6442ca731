"""LPIPS (VGG16) perceptual distance.

Counterpart of ``autovfx_tpu/utils/lpips_jax.py``: VGG16 features at the
five canonical taps (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), unit
normalized per channel, squared differences weighted by the linear heads,
averaged over space and summed over taps, the LPIPS(vgg) formulation.

The weights load from an ``.npz`` at ``AUTOVFX_LPIPS_WEIGHTS`` (keys
``conv{i}_w`` (OIHW, or HWIO as the JAX package reads them too),
``conv{i}_b``, ``lin{k}``: the layout of the JAX package's
``convert_torch_lpips``).  Without one, the network takes
deterministic He-initialized random filters (seed 0, the same numpy
draws as the JAX package, so the two are bit-equal) and uniform heads:
a usable relative metric, not comparable to canonical LPIPS numbers,
and ``source`` says so.

The convolutions run in NCHW with OIHW weights, padding 1, in IEEE
float32 whatever the TF32 flags say (``utils.conv``); the 2×2 pools
floor odd sizes, as the JAX package's "VALID" windows do.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.utils.conv import conv2d

# VGG16's convolutions: (out channels, a 2×2 max pool before it); the
# taps follow the ReLUs of _TAPS
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
_TAPS = (1, 3, 6, 9, 12)
# ImageNet normalization (the LPIPS "scaling layer")
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPSParams(NamedTuple):
    convs: tuple  # ((w (out, in, 3, 3), b (out,)), ...) tensors
    lins: tuple  # per tap (C,) nonnegative head weights
    source: str  # "file" | "random"


def _tensors(convs, lins, source, device) -> LPIPSParams:
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return LPIPSParams(convs=tuple((t(w), t(b)) for w, b in convs),
                       lins=tuple(t(x) for x in lins), source=source)


def _random_params(seed: int = 0, device=devices.DEFAULT) -> LPIPSParams:
    """He-initialized filters from numpy's ``RandomState(seed)``, drawn
    in the JAX package's (3, 3, in, out) order, and uniform heads."""
    device = devices.resolve(device)
    rng = np.random.RandomState(seed)
    convs = []
    cin = 3
    for cout, _ in _VGG_PLAN:
        std = float(np.sqrt(2.0 / (3 * 3 * cin)))
        w = rng.randn(3, 3, cin, cout).astype(np.float32) * std
        convs.append((w.transpose(3, 2, 0, 1), np.zeros((cout,), np.float32)))
        cin = cout
    lins = [np.full((_VGG_PLAN[t][0],), 1.0 / _VGG_PLAN[t][0], np.float32)
            for t in _TAPS]
    return _tensors(convs, lins, "random", device)


def _file_params(path: str, device=devices.DEFAULT) -> LPIPSParams:
    """The weights of an ``.npz``: convolutions OIHW (HWIO ones are
    transposed), heads flattened and clipped at 0."""
    device = devices.resolve(device)
    data = np.load(path)
    convs = []
    for i in range(len(_VGG_PLAN)):
        w = np.asarray(data[f"conv{i}_w"], np.float32)
        if w.shape[0] == 3 and w.shape[1] == 3:  # HWIO -> OIHW
            w = w.transpose(3, 2, 0, 1)
        convs.append((w, np.asarray(data[f"conv{i}_b"], np.float32)))
    lins = [np.maximum(np.asarray(data[f"lin{k}"], np.float32).reshape(-1), 0)
            for k in range(len(_TAPS))]
    return _tensors(convs, lins, "file", device)


@functools.lru_cache(maxsize=4)
def _cached_params(path: Optional[str], device: torch.device) -> LPIPSParams:
    if path and os.path.exists(path):
        return _file_params(path, device)
    return _random_params(device=device)


def get_params(weights_path: Optional[str] = None,
               device=devices.DEFAULT) -> LPIPSParams:
    """The weights at ``weights_path`` (or ``AUTOVFX_LPIPS_WEIGHTS``)
    when that file exists, else the seed-0 random features, on
    ``device``; cached."""
    path = weights_path or os.environ.get("AUTOVFX_LPIPS_WEIGHTS")
    return _cached_params(path, devices.resolve(device))


def convert_torch_lpips(vgg_state: dict, lpips_state: dict) -> dict:
    """The ``AUTOVFX_LPIPS_WEIGHTS`` ``.npz`` arrays from torchvision's
    VGG16 and the ``lpips`` package's linear heads (numpy in, numpy out:
    the state dicts' tensors already converted to arrays), as the JAX
    package's ``convert_torch_lpips`` writes them.

    ``vgg_state``: torchvision ``vgg16().state_dict()``, convolutions at
    ``features.{0,2,5,7,10,12,14,17,19,21,24,26,28}.weight/bias`` (OIHW,
    kept so).  ``lpips_state``: ``lpips.LPIPS(net='vgg').state_dict()``,
    heads at ``lins.{k}.model.1.weight`` (or, in older releases,
    ``lin{k}.model.1.weight``), 1×1 convolutions (1, C, 1, 1)."""
    torch_conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    out = {}
    for k, ti in enumerate(torch_conv_idx):
        w = np.asarray(vgg_state[f"features.{ti}.weight"], np.float32)
        b = np.asarray(vgg_state[f"features.{ti}.bias"], np.float32)
        if w.shape[2:] != (3, 3) or w.shape[0] != _VGG_PLAN[k][0]:
            raise ValueError(f"features.{ti}.weight has shape {w.shape}, "
                             f"not ({_VGG_PLAN[k][0]}, in, 3, 3)")
        out[f"conv{k}_w"] = w
        out[f"conv{k}_b"] = b
    for k in range(len(_TAPS)):
        key = f"lins.{k}.model.1.weight"
        if key not in lpips_state:  # older lpips layout
            key = f"lin{k}.model.1.weight"
        lin = np.asarray(lpips_state[key], np.float32).reshape(-1)
        if lin.shape[0] != _VGG_PLAN[_TAPS[k]][0]:
            raise ValueError(f"{key} has {lin.shape[0]} weights, not "
                             f"{_VGG_PLAN[_TAPS[k]][0]}")
        out[f"lin{k}"] = lin
    return out


def _features(x: torch.Tensor, params: LPIPSParams) -> list:
    """x: (B, H, W, 3) in [-1, 1] -> the five taps' (B, C, h, w)."""
    shift = torch.from_numpy(_SHIFT).to(x.device)
    scale = torch.from_numpy(_SCALE).to(x.device)
    x = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    for i, ((_, pool), (w, b)) in enumerate(zip(_VGG_PLAN, params.convs)):
        if pool:
            x = F.max_pool2d(x, 2)
        x = torch.relu(conv2d(x, w, padding=1) + b[:, None, None])
        if i in _TAPS:
            feats.append(x)
    return feats


def lpips_distance(
    img1: torch.Tensor,
    img2: torch.Tensor,
    params: Optional[LPIPSParams] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LPIPS between (H, W, 3) images in [0, 1] (or batches (B, H, W, 3)),
    on their device (the parameters default to ``get_params()`` there).

    ``mask`` (H, W): the spatial mean over masked pixels only, the mask
    max-pooled down to each tap's size."""
    if params is None:
        params = get_params(device=img1.device)
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    f1 = _features(img1 * 2.0 - 1.0, params)
    f2 = _features(img2 * 2.0 - 1.0, params)
    total = 0.0
    for a, b, lin in zip(f1, f2, params.lins):
        a = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True),
                            min=1e-10)
        b = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True),
                            min=1e-10)
        d = torch.sum((a - b) ** 2 * lin[:, None, None], dim=1)  # (B, h, w)
        if mask is not None:
            m = mask[None].to(torch.float32)
            while m.shape[1] > d.shape[1]:  # pool to this tap's size
                m = F.max_pool2d(m[:, None], 2)[:, 0]
            m = m[:, :d.shape[1], :d.shape[2]]
            total = total + torch.sum(d * m, dim=(1, 2)) / torch.clamp(
                torch.sum(m, dim=(1, 2)), min=1.0)
        else:
            total = total + torch.mean(d, dim=(1, 2))
    return total[0] if squeeze else total
