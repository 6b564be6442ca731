"""Equirectangular environment maps: sampling, rotation, light directions.

Counterpart of ``autovfx_tpu/render/envmap.py``.  Convention (Blender
equirect, z up): u wraps the azimuth with -x at u = 0.5, v = 0 at +z.

``importance_directions`` differs from the reference in one place: the
reference divides by the density's sum without a guard
(``envmap.py:145``), so an envmap whose energy lies all below the
horizon gives NaN directions with ``up``; here the density falls back
(see its docstring).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def direction_to_uv(dirs: torch.Tensor) -> torch.Tensor:
    """Unit world directions (..., 3) -> equirect uv in [0, 1]^2."""
    x, y, z = dirs.unbind(-1)
    theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
    phi = torch.atan2(-y, -x)
    u = phi / (2.0 * math.pi) + 0.5
    v = theta / math.pi
    return torch.stack([u, v], dim=-1)


def uv_to_direction(uv: torch.Tensor) -> torch.Tensor:
    u, v = uv.unbind(-1)
    theta = v * math.pi
    phi = (u - 0.5) * 2.0 * math.pi
    st = torch.sin(theta)
    return torch.stack(
        [-st * torch.cos(phi), -st * torch.sin(phi), torch.cos(theta)], dim=-1
    )


def _texel_uv(h: int, w: int, device=None) -> torch.Tensor:
    """(H, W, 2) float32 uv of the texel centers."""
    uu, vv = np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h)
    return torch.tensor(np.stack([uu, vv], -1), dtype=torch.float32,
                        device=device)


def texel_directions(h: int, w: int) -> np.ndarray:
    """(H, W, 3) float32 directions of the texel centers (numpy)."""
    return uv_to_direction(_texel_uv(h, w)).numpy()


def sample_envmap(env: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample an (H, W, 3) equirect map at directions (..., 3)."""
    h, w, _ = env.shape
    uv = direction_to_uv(dirs)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)  # wraps like jnp.mod
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00 = env[y0i, x0i]
    c01 = env[y0i, x1i]
    c10 = env[y1i, x0i]
    c11 = env[y1i, x1i]
    return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
            + c10 * (1 - fx) * fy + c11 * fx * fy)


def rotate_envmap_cam_to_world(env: torch.Tensor,
                               c2w: torch.Tensor) -> torch.Tensor:
    """Re-orient a camera-frame equirect (DiffusionLight's axes [z, -x,
    -y]) to the world frame by resampling it."""
    h, w, _ = env.shape
    dirs_world = uv_to_direction(_texel_uv(h, w, env.device))
    r = c2w[:3, :3].to(env.dtype)
    dirs_cam = dirs_world @ r  # world -> camera (R^T applied to rows)
    dirs_env = torch.stack(
        [dirs_cam[..., 2], -dirs_cam[..., 0], -dirs_cam[..., 1]], dim=-1
    )
    return sample_envmap(env, dirs_env)


def sun_direction(env: torch.Tensor) -> torch.Tensor:
    """Direction of the brightest texel (the first on ties)."""
    h, w, _ = env.shape
    idx = torch.argmax(env.sum(-1).reshape(-1))
    y, x = idx // w, idx % w
    uv = torch.stack([(x + 0.5) / w, (y + 0.5) / h]).to(torch.float32)
    return uv_to_direction(uv)


def importance_directions(
    env: np.ndarray, num: int, seed: int = 0,
    up: np.ndarray | None = None, stratified: bool = False,
    dedup: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: luminance-importance-sampled light directions and their
    contributions, (dirs (L, 3), contrib (L, 3)) float32.

    The sampling density is the texel's luminance times its solid angle
    (sin θ), and with ``up`` also the diffuse-catcher cosine max(dir·up,
    0), which the contributions then carry too: Σ w·vis / Σ w estimates
    the white-catcher shadow ratio ∫L·vis·cos⁺ / ∫L·cos⁺.  ``stratified``
    draws by systematic inverse-CDF resampling; ``dedup`` merges draws of
    one texel (their weights add).

    Where the density sums to zero (with ``up``: all the energy below
    the horizon), it falls back to the density without the cosine, and
    where that is zero too (a black envmap), to the solid angle alone
    (uniform directions); the contributions are then those of the
    density actually sampled (zero for a black envmap).  The reference
    divides by the zero sum and returns NaN directions.
    """
    env = np.asarray(env, np.float32)
    h, w, _ = env.shape
    v = (np.arange(h) + 0.5) / h
    sin_theta = np.sin(v * np.pi)[:, None]
    lum = env.sum(-1) * sin_theta  # solid-angle weighted luminance
    dens = lum
    if up is not None:
        tex_dirs = texel_directions(h, w).astype(np.float64)
        cos_up = np.maximum(tex_dirs @ np.asarray(up, np.float64), 0.0)
        dens = dens * cos_up.astype(np.float32)
    for candidate in (dens, lum, np.broadcast_to(sin_theta, lum.shape)):
        total = candidate.sum()
        if total > 0:
            dens = candidate
            break
    p = dens.reshape(-1) / total
    rng = np.random.RandomState(seed)
    if stratified:
        cdf = np.cumsum(p)
        u = (np.arange(num) + rng.rand(num)) / num
        idx = np.minimum(np.searchsorted(cdf, u), len(p) - 1)
    else:
        idx = rng.choice(len(p), size=num, p=p)
    if dedup:
        idx, mult = np.unique(idx, return_counts=True)
    else:
        mult = np.ones(len(idx))
    ys, xs = idx // w, idx % w
    uv = np.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1)
    dirs = uv_to_direction(torch.tensor(uv, dtype=torch.float32)).numpy()
    # each draw's contribution f / pdf / num (pdf in solid angle); f = L,
    # or L·cos⁺ when ``up`` folds in the catcher cosine
    d_omega = (2 * np.pi / w) * (np.pi / h) * sin_theta.reshape(-1)[ys]
    pdf = p[idx] / np.maximum(d_omega, 1e-9)
    f = env.reshape(-1, 3)[idx]
    if up is not None:
        f = f * np.maximum(dirs @ np.asarray(up, np.float64), 0.0)[:, None]
    contrib = f * mult[:, None] / np.maximum(pdf[:, None], 1e-9) / num
    return dirs.astype(np.float32), contrib.astype(np.float32)


def load_envmap(path: str) -> np.ndarray:
    """Load an equirect envmap: .npy/.npz, .exr/.hdr (cv2 or imageio),
    or an LDR image (to approximately linear by a 2.2 power)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".npz"):
        z = np.load(path)
        return z[list(z.keys())[0]].astype(np.float32)
    if path.endswith(".exr") or path.endswith(".hdr"):
        try:
            import cv2

            img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
            return img[..., ::-1].astype(np.float32)
        except ImportError:
            import imageio.v2 as imageio

            return np.asarray(imageio.imread(path), np.float32)
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img ** 2.2
