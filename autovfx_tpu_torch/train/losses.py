"""Training losses for 3DGS / SuGaR.

Counterpart of ``autovfx_tpu/train/losses.py`` (itself
``sugar/gaussian_splatting/utils/loss_utils.py``), with its conventions:
the 11×11, σ = 1.5 Gaussian-window SSIM with zero "SAME" padding
(``F.conv2d``, as two 1-D passes of the separable window), the
detached least-squares fit and the ``/25`` divisor of the mono-depth
loss, the depth mask of the normal loss, the zero border of
``depth_to_normal``, and masked means instead of boolean indexing.
Images are (H, W, C) as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from autovfx_tpu_torch.utils.conv import conv2d

# ---- photometric -----------------------------------------------------------


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


@functools.lru_cache(maxsize=None)
def _gaussian_window_1d(window_size: int = 11, sigma: float = 1.5):
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter2d(img: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """(H, W, C) zero-padded "SAME" filter of each channel with the
    Gaussian window outer(g, g), applied as its two 1-D passes: the
    same sums as the JAX package's 2-D convolution in another order,
    with 2k instead of k² products per pixel.  Float32 on the card
    whatever the TF32 flags say (``utils.conv``)."""
    g = torch.from_numpy(_gaussian_window_1d(window_size)).to(img.device)
    k = window_size // 2
    x = img.permute(2, 0, 1)[:, None]  # channels as the batch
    x = conv2d(x, g.reshape(1, 1, 1, -1), padding=(0, k))
    x = conv2d(x, g.reshape(1, 1, -1, 1), padding=(k, 0))
    return x[:, 0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair (the 11×11, σ = 1.5
    Gaussian window; the five filtered images in one call)."""
    c = img1.shape[-1]
    stats = _filter2d(torch.cat([img1, img2, img1 * img1, img2 * img2,
                                 img1 * img2], dim=-1), window_size)
    mu1, mu2, e11, e22, e12 = stats.split(c, dim=-1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1-λ)·L1 + λ·(1-SSIM), the 3DGS training loss."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt))


# ---- geometric regularizers --------------------------------------------------


def compute_scale_and_shift(pred, target, mask):
    """Masked least-squares (scale, shift) aligning ``pred`` to
    ``target``, a closed-form 2×2 solve; (0, 0) when it is singular."""
    w = mask.to(torch.float32)
    a00 = torch.sum(w * pred * pred)
    a01 = torch.sum(w * pred)
    a11 = torch.sum(w)
    b0 = torch.sum(w * pred * target)
    b1 = torch.sum(w * target)
    det = a00 * a11 - a01 * a01
    ok = det > 0
    safe_det = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    scale = torch.where(ok, (a11 * b0 - a01 * b1) / safe_det, zero)
    shift = torch.where(ok, (-a01 * b0 + a00 * b1) / safe_det, zero)
    return scale, shift


def depth_loss(pred: torch.Tensor, mono_gt: torch.Tensor,
               scene_scale: float = 5.0,
               gt_divisor: float = 25.0) -> torch.Tensor:
    """Scale-shift-invariant mono-depth regularizer: the GT divided by
    ``gt_divisor``, aligned to a detached prediction by least squares,
    weighted by exp(-d/s)."""
    pred = pred.reshape(-1)
    gt = mono_gt.reshape(-1) / gt_divisor
    mask = gt > 0
    fixed = pred.detach()
    scale, shift = compute_scale_and_shift(fixed, gt, mask)
    w = mask.to(torch.float32) * torch.exp(-fixed / scene_scale)
    return torch.mean(w * (scale * pred + shift - gt) ** 2)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def normal_loss(pred: torch.Tensor, gt: torch.Tensor,
                depth: Optional[torch.Tensor] = None,
                scene_scale: float = 5.0) -> torch.Tensor:
    """L1 + 0.1·(-cos) on normalized normals, masked to
    0 < depth < scene_scale when ``depth`` is given."""
    np_, ng = _unit(pred), _unit(gt)
    if depth is not None:
        m = ((depth > 0) & (depth < scene_scale)).to(torch.float32)[..., None]
        denom = torch.clamp(m.sum() * 3, min=1.0)
        l1 = torch.sum(m * torch.abs(np_ - ng)) / denom
        cos = -torch.sum(m[..., 0] * torch.sum(np_ * ng, dim=-1)) / torch.clamp(
            m.sum(), min=1.0)
    else:
        l1 = torch.mean(torch.abs(np_ - ng))
        cos = -torch.mean(torch.sum(np_ * ng, dim=-1))
    return l1 + 0.1 * cos


def opacity_loss(alpha: torch.Tensor) -> torch.Tensor:
    """Mean rendered alpha (floater suppressor)."""
    return torch.mean(alpha)


def _masked_mean(term: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return torch.mean(term)
    m = mask.to(torch.float32)
    return torch.sum(term * m) / torch.clamp(m.sum(), min=1.0)


def sparsity_loss(opacity: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log(o) + log(1-o), the binary-entropy push."""
    val = torch.clamp(opacity, 1e-3, 1 - 1e-3)
    return _masked_mean(torch.log(val) + torch.log(1 - val), mask)


def anisotropic_loss(scales: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     r: float = 3.0) -> torch.Tensor:
    """PhysGaussian's max/min scale ratio clamp."""
    ratio = scales.amax(dim=-1) / (scales.amin(dim=-1) + 1e-6)
    return _masked_mean(torch.clamp(ratio, min=r) - r, mask)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


# ---- depth -> pseudo-normal ---------------------------------------------------


def depth_to_normal(points3d: torch.Tensor) -> torch.Tensor:
    """Pseudo-normals of back-projected depth (H, W, 3): cross products
    of central differences, normalized, with a zero one-pixel border."""
    top = points3d[:-2, 1:-1]
    bottom = points3d[2:, 1:-1]
    left = points3d[1:-1, :-2]
    right = points3d[1:-1, 2:]
    normal = _unit(torch.linalg.cross(right - left, top - bottom, dim=-1))
    return F.pad(normal, (0, 0, 1, 1, 1, 1))
