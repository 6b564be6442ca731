"""Plain PyTorch 3DGS training step: the render, the loss
((1 − λ)·L1 + λ·(1 − SSIM), 11×11 Gaussian window σ 1.5), its gradient
through the plain blend backward and autograd of the plain preprocess,
and Adam (b1 0.9, b2 0.999, eps 1e-15, the reference's per-field
learning rates and exponential position rate).

A frozen copy of the program's plain paths (``train/losses``,
``train/trainer.apply_adam``) with no import of the program.
Convolutions and matrix products run in IEEE float32 (TF32 off).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import raster

FIELDS = ("xyz", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logit")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


@contextlib.contextmanager
def ieee_float32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, size: int = 11) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images (zero-padded "same" filter)."""
    c = a.shape[-1]
    g = torch.from_numpy(_window(size)).to(a.device)
    k = size // 2
    x = torch.cat([a, b, a * a, b * b, a * b], -1).permute(2, 0, 1)[:, None]
    x = F.conv2d(x, g.reshape(1, 1, 1, -1), padding=(0, k))
    x = F.conv2d(x, g.reshape(1, 1, -1, 1), padding=(k, 0))
    mu1, mu2, e11, e22, e12 = x[:, 0].permute(1, 2, 0).split(c, dim=-1)
    s1, s2, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                      / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)))


def photometric_loss(pred, gt, lambda_dssim: float) -> torch.Tensor:
    return ((1.0 - lambda_dssim) * torch.mean(torch.abs(pred - gt))
            + lambda_dssim * (1.0 - ssim(pred, gt)))


@dataclasses.dataclass
class Adam:
    m: dict
    v: dict
    count: int = 0


def position_lr(step: int, t: dict) -> float:
    f32 = np.float32
    init = f32(t["position_lr_init"] * t["spatial_lr_scale"])
    final = f32(max(t["position_lr_final"] * t["spatial_lr_scale"], 1e-12))
    x = f32(np.clip(f32(step) / f32(t["position_lr_max_steps"]), 0.0, 1.0))
    return float(np.exp(np.log(init) * (f32(1) - x) + np.log(final) * x))


def field_lrs(step: int, t: dict) -> dict:
    return {"xyz": position_lr(step, t), "sh_dc": t["feature_lr"],
            "sh_rest": t["feature_lr"] / 20.0, "log_scales": t["scaling_lr"],
            "quats": t["rotation_lr"], "opacity_logit": t["opacity_lr"]}


def loss_and_grads(g: dict, cam: raster.Cam, target: torch.Tensor,
                   tile: int, lambda_dssim: float, lowp: bool = False):
    """(loss, {field: gradient}) of one view, black background."""
    q = raster.rounder(lowp)
    with ieee_float32():
        params = {f: g[f].detach().clone().requires_grad_(True)
                  for f in FIELDS}
        with torch.enable_grad():
            s = raster.preprocess(dict(params, active=g["active"]), cam,
                                  tile, lowp)
        sd = raster.Splats(*(x.detach() for x in s))
        with torch.no_grad():
            b = raster.bin_splats(sd, cam.width, cam.height, tile)
            img = raster.blend(sd, b, cam.width, cam.height, tile, lowp)
        color = img.color.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = photometric_loss(color, target, lambda_dssim)
            (g_color,) = torch.autograd.grad(loss, [color])
        with torch.no_grad():
            zeros = torch.zeros_like(img.alpha)
            sg = raster.blend_bwd(sd, b, q(g_color), zeros, zeros, tile, lowp)
        with torch.enable_grad():
            torch.autograd.backward(
                [s.mean2d, s.conic, s.color, s.opacity, s.depth],
                [sg.mean2d, sg.conic, sg.color, sg.opacity, sg.depth])
    return loss.detach(), {f: q(params[f].grad) for f in FIELDS}


def adam_step(g: dict, adam: Adam, grads: dict, step: int, t: dict) -> None:
    """One Adam update of every field, masked to active slots, in place."""
    lrs = field_lrs(step, t)
    adam.count += 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(ADAM_B1) ** f32(adam.count))
    bc2 = float(f32(1) - f32(ADAM_B2) ** f32(adam.count))
    with torch.no_grad():
        for f in FIELDS:
            gr, m, v, p = grads[f], adam.m[f], adam.v[f], g[f]
            m.mul_(ADAM_B1).add_(gr, alpha=1 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(gr, gr, value=1 - ADAM_B2)
            up = lrs[f] * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
            mask = g["active"].reshape((-1,) + (1,) * (gr.ndim - 1))
            p.sub_(torch.where(mask, up, torch.zeros_like(up)))


def run(start: dict, cams: list, targets: list, tile: int, t: dict,
        lowp: bool = False) -> dict:
    """``len(cams)`` steps from ``start`` (not modified), step k on view
    k: the losses, the first step's gradients and the parameters' change."""
    g = {f: start[f].clone() for f in FIELDS}
    g["active"] = start["active"]
    adam = Adam(m={f: torch.zeros_like(g[f]) for f in FIELDS},
                v={f: torch.zeros_like(g[f]) for f in FIELDS})
    losses, first = [], None
    for k, (cam, target) in enumerate(zip(cams, targets)):
        loss, grads = loss_and_grads(g, cam, target, tile,
                                     t["lambda_dssim"], lowp)
        losses.append(float(loss))
        if first is None:
            first = grads
        adam_step(g, adam, grads, k, t)
        del grads
    return {"losses": losses, "grads": first,
            "change": {f: g[f] - start[f] for f in FIELDS}}
