"""DiffusionLight post-processing: chrome-ball crops -> an HDR envmap.

Counterpart of ``autovfx_tpu/render/difflight.py``.  The lighting
estimate inpaints a chrome ball into the anchor frame at three exposure
brackets (EV 0 / -2.5 / -5); these stages turn the precomputed ball
crops into the envmap:

1. ball -> equirect unwrap by the mirror-reflection mapping,
2. EV brackets -> a linear HDR merge,
3. camera -> world rotation (``render.envmap.rotate_envmap_cam_to_world``,
   on a chosen device).

Stages 1-2 are host-side numpy, once per anchor frame.  Reading ``.png``
or ``.jpg`` crops needs PIL, imported only when such a file is read;
``.npy`` crops need nothing more.

Conventions (Blender's): the camera looks along +x; the equirect texel
at (row v, col u) maps to the unit reflection vector
R = (sin φ cos θ, sin φ sin θ, cos φ) with θ ∈ [0, 2π] across the width
and φ ∈ [0, π] down the height; the ball normal for that texel is
N = normalize(I + R) with I = (1, 0, 0), and the ball image is indexed
by the (y, z) components of N mapped to [0, 1] (an orthographic mirror
ball).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices

# Rec.709 luminance (exposure2hdr.py:71)
_LUMA = np.array([0.212671, 0.715160, 0.072169], np.float64)


def _bilinear_border(img: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Bilinear lookup with border clamping, align_corners=True
    semantics: x, y in [0, 1] map to pixel centers [0, S-1]."""
    h, w = img.shape[:2]
    fx = np.clip(x, 0.0, 1.0) * (w - 1)
    fy = np.clip(y, 0.0, 1.0) * (h - 1)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    top = img[y0, x0] * (1 - tx) + img[y0, x1] * tx
    bot = img[y1, x0] * (1 - tx) + img[y1, x1] * tx
    return top * (1 - ty) + bot * ty


def unwrap_ball_to_envmap(
    ball: np.ndarray, env_height: int = 512, scale: int = 4
) -> np.ndarray:
    """Chrome-ball image → (env_height, 2·env_height, 3) equirect map.

    Mirror-reflection mapping (ball2envmap.py:54-147): for every
    equirect texel build the reflection direction R, recover the ball
    normal N = normalize(I + R) under the orthographic camera I=(1,0,0),
    and bilinearly sample the ball image at the (y, z) projection of N.
    Rendered at ``scale``× and box-filtered down (the reference renders
    at 4x and anti-alias-resizes).
    """
    ball = np.asarray(ball, np.float64)
    hh = env_height * scale
    ww = 2 * hh
    theta = np.linspace(0.0, 2.0 * np.pi, ww)[None, :]
    phi = np.linspace(0.0, np.pi, hh)[:, None]
    rx = np.sin(phi) * np.cos(theta)
    ry = np.sin(phi) * np.sin(theta)
    rz = np.cos(phi) * np.ones_like(theta)
    # N = normalize(I + R), I = (1, 0, 0)
    nx = rx + 1.0
    norm = np.sqrt(nx * nx + ry * ry + rz * rz)
    ny = ry / norm
    nz = rz / norm
    # ball lookup position: pos = 1 - (N+1)/2, components (y, z);
    # grid_sample(x=pos_y, y=pos_z) → image column ∝ pos_y, row ∝ pos_z
    px = 1.0 - (ny + 1.0) / 2.0
    py = 1.0 - (nz + 1.0) / 2.0
    env = _bilinear_border(ball, px, py)
    # box-filter downsample back to the requested size
    env = env.reshape(
        env_height, scale, 2 * env_height, scale, -1
    ).mean(axis=(1, 3))
    return env.astype(np.float32)


def merge_exposure_brackets(
    images: list[np.ndarray],
    evs: list[float] = (0.0, -2.5, -5.0),
    gamma: float = 2.4,
) -> np.ndarray:
    """LDR exposure brackets → linear HDR radiance (exposure2hdr.py).

    ``images``: sRGB-ish LDR arrays in [0, 1] (any resolution, all
    equal), ordered to match ``evs``.  Each bracket is linearized with
    ``img**gamma / 2**ev``; saturated regions of brighter brackets are
    replaced (with a soft 90 %-luminance blend) by the darker bracket's
    luminance, and the merged luminance rescales the EV-0 linear RGB.
    """
    order = np.argsort(evs)[::-1]  # brightest (highest EV) first
    evs_sorted = [float(evs[i]) for i in order]
    imgs = [np.asarray(images[i], np.float64)[..., :3] for i in order]
    linear = [
        np.power(im, gamma) / (2.0 ** ev)
        for im, ev in zip(imgs, evs_sorted)
    ]
    lum = [li @ _LUMA for li in linear]

    out_lum = lum[-1]  # darkest
    for i in range(len(evs_sorted) - 1, 0, -1):
        maxval = 1.0 / (2.0 ** evs_sorted[i - 1])
        p1 = np.clip((lum[i - 1] - 0.9 * maxval) / (0.1 * maxval), 0, 1)
        p2 = out_lum > lum[i - 1]
        mask = p1 * p2
        out_lum = lum[i - 1] * (1.0 - mask) + out_lum * mask

    hdr = linear[0] * (out_lum / (lum[0] + 1e-10))[..., None]
    return hdr.astype(np.float32)


def envmap_from_ball_crops(
    crops_by_ev: dict[float, np.ndarray],
    c2w: np.ndarray | None = None,
    env_height: int = 512,
    gamma: float = 2.4,
    device=devices.DEFAULT,
) -> np.ndarray:
    """Full native post-processing chain: SDXL chrome-ball crops (one
    LDR image per EV bracket) → rotated linear HDR equirect envmap.

    These are stages 2–4 of DiffusionLight's
    ``get_envmap_from_single_view``; only the SDXL inpainting itself
    stays a precomputed input.  ``c2w`` given →
    rotate from camera into world frame (envmap.py axis convention) on
    ``device``.
    """
    evs = sorted(crops_by_ev.keys(), reverse=True)
    unwrapped = [
        unwrap_ball_to_envmap(crops_by_ev[ev], env_height=env_height)
        for ev in evs
    ]
    hdr = merge_exposure_brackets(unwrapped, evs, gamma=gamma)
    if c2w is not None:
        from autovfx_tpu_torch.render.envmap import rotate_envmap_cam_to_world

        device = devices.resolve(device)
        hdr = rotate_envmap_cam_to_world(
            torch.tensor(hdr, device=device),
            torch.tensor(np.asarray(c2w, np.float32), device=device),
        ).cpu().numpy()
    return hdr


def load_ball_crops(crops_dir: str) -> dict[float, np.ndarray]:
    """Read SDXL chrome-ball crops named ``ball_ev<EV*10>.(npy|png)``
    (e.g. ball_ev0.npy, ball_ev-25.png → EV 0 / −2.5) as [0,1] floats —
    the reference's square_ev* intermediates (inpaint.py EV brackets)."""
    import re

    out: dict[float, np.ndarray] = {}
    for name in sorted(os.listdir(crops_dir)):
        m = re.match(r"ball_ev(-?\d+)\.(npy|png|jpg)$", name)
        if not m:
            continue
        ev = int(m.group(1)) / 10.0
        path = os.path.join(crops_dir, name)
        if name.endswith(".npy"):
            img = np.load(path)
        else:
            from PIL import Image

            img = np.asarray(Image.open(path), np.float32) / 255.0
        out[ev] = np.asarray(img, np.float32)[..., :3]
    if not out:
        raise FileNotFoundError(
            f"no ball_ev*.npy/png crops in {crops_dir} (expected the "
            "precomputed DiffusionLight chrome-ball EV brackets)"
        )
    return out


def render_mirror_ball(
    env: np.ndarray, ball_size: int = 256
) -> np.ndarray:
    """Synthetic oracle for the unwrap: render an orthographic mirror
    ball lit by ``env`` with the exact inverse mapping (per ball pixel:
    N from the (y, z) position, R = 2(N·I)N − I, sample env at R).

    Used by tests to verify unwrap_ball_to_envmap round-trips.
    """
    env = np.asarray(env, np.float64)
    he, we = env.shape[:2]
    # ball pixel grid → normal components (inverse of the unwrap's pos)
    v = np.linspace(0.0, 1.0, ball_size)
    py, px = np.meshgrid(v, v, indexing="ij")
    ny = 1.0 - 2.0 * px
    nz = 1.0 - 2.0 * py
    r2 = ny * ny + nz * nz
    inside = r2 <= 1.0
    nx = np.sqrt(np.maximum(1.0 - r2, 0.0))
    # R = 2(N·I)N − I with I = (1, 0, 0)
    rx = 2.0 * nx * nx - 1.0
    ry = 2.0 * nx * ny
    rz = 2.0 * nx * nz
    # spherical coords matching the unwrap grid
    phi = np.arccos(np.clip(rz, -1.0, 1.0))
    theta = np.mod(np.arctan2(ry, rx), 2.0 * np.pi)
    x = theta / (2.0 * np.pi)
    y = phi / np.pi
    ball = _bilinear_border(env, x, y)
    return np.where(inside[..., None], ball, 0.0).astype(np.float32)
