"""PBR material application: PolyHaven texture folders onto surfels.

A numpy copy of ``autovfx_tpu/render/materials.py`` (the port imports no
module of the JAX package).  Parity target: ``blender/all_rendering.py:
1019-1062`` (``change_materials``: diffuse / normal(gl) / displacement /
roughness maps wired into a Principled BSDF) and ``:1083-1134``
(``change_texture_color``: hue-shift recolor toward a target RGB by
``move_ratio`` of the hue gap).

The maps are sampled once onto the object's surfels on the host
(colors, per-surfel roughness, normal perturbation, displacement along
the normal), so the device's IBL shading reads no texture.
"""
from __future__ import annotations

import glob
import os
from typing import NamedTuple, Optional

import numpy as np


class Material(NamedTuple):
    diffuse: np.ndarray  # (H, W, 3) float 0..1
    roughness: Optional[np.ndarray] = None  # (H, W) float 0..1
    normal: Optional[np.ndarray] = None  # (H, W, 3) tangent-space, 0..1
    displacement: Optional[np.ndarray] = None  # (H, W) float 0..1


def _find_map(folder: str, patterns) -> Optional[str]:
    for pat in patterns:
        hits = sorted(
            glob.glob(os.path.join(folder, f"*{pat}*"))
            + glob.glob(os.path.join(folder, "**", f"*{pat}*"),
                        recursive=True)
        )
        hits = [
            h for h in hits
            if h.lower().endswith((".png", ".jpg", ".jpeg", ".exr",
                                   ".tga", ".bmp"))
        ]
        if hits:
            return hits[0]
    return None


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img


def load_material_folder(path: str) -> Material:
    """Load a PolyHaven-style material folder.

    Accepts either the raw folder, or the reference's
    ``<folder>/<name>_1k/textures`` nesting (all_rendering.py:1023-1024);
    map discovery mirrors the reference's glob patterns (:1025-1028).
    """
    name = os.path.basename(os.path.normpath(path))
    nested = os.path.join(path, name + "_1k", "textures")
    folder = nested if os.path.isdir(nested) else path
    diff = _find_map(folder, ("diff", "albedo", "color", "col"))
    if diff is None:
        raise FileNotFoundError(
            f"no diffuse map (*diff*/*albedo*/*color*) under {folder}"
        )
    rough = _find_map(folder, ("rough",))
    nor = _find_map(folder, ("nor_gl", "normal", "nor"))
    disp = _find_map(folder, ("disp", "height"))
    return Material(
        diffuse=_load_image(diff),
        roughness=_load_image(rough)[..., 0] if rough else None,
        normal=_load_image(nor) if nor else None,
        displacement=_load_image(disp)[..., 0] if disp else None,
    )


def triplanar_uv(points: np.ndarray, normals: np.ndarray):
    """Box-projected (u, v) per sample from object-local coordinates.

    The dominant-normal axis picks the projection plane (the standard
    substitute for Blender's UV unwrap when the asset ships none).
    """
    p = np.asarray(points, np.float64)
    n = np.abs(np.asarray(normals, np.float64))
    axis = np.argmax(n, axis=1)  # 0=x-dominant → project yz, etc.
    u = np.where(axis == 0, p[:, 1], np.where(axis == 1, p[:, 0], p[:, 0]))
    v = np.where(axis == 0, p[:, 2], np.where(axis == 1, p[:, 2], p[:, 1]))
    return u, v


def sample_texture(tex: np.ndarray, u, v, tile: float = 1.0):
    """Wrap-sample a texture at (u, v) (nearest; surfels supersample)."""
    h, w = tex.shape[:2]
    ui = np.mod(np.floor(u * tile * w), w).astype(np.int64)
    vi = np.mod(np.floor(v * tile * h), h).astype(np.int64)
    return tex[vi, ui]


def _tangent_frame(normals: np.ndarray):
    n = normals / np.maximum(
        np.linalg.norm(normals, axis=1, keepdims=True), 1e-12
    )
    helper = np.where(
        np.abs(n[:, 2:3]) < 0.9,
        np.array([0.0, 0.0, 1.0]),
        np.array([1.0, 0.0, 0.0]),
    )
    t = np.cross(helper, n)
    t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-12)
    b = np.cross(n, t)
    return t, b, n


def apply_material_to_surfels(
    surfels: dict,
    mat: Material,
    uv_tile: float = 1.0,
    displacement_scale: float = 0.02,
    normal_strength: float = 1.0,
) -> dict:
    """New surfels dict with the material's maps baked in.

    Mirrors the reference node graph (all_rendering.py:1055-1062):
    diffuse → base color, roughness → per-surfel roughness,
    normal map → tangent-frame normal perturbation, displacement →
    offset along the (unperturbed) normal.
    """
    pts = np.asarray(surfels["points"], np.float64).copy()
    nrm = np.asarray(surfels["normals"], np.float64)
    u, v = triplanar_uv(pts, nrm)

    out = dict(surfels)
    out["colors"] = sample_texture(mat.diffuse, u, v, uv_tile).astype(
        np.float32
    )
    if mat.roughness is not None:
        out["roughness"] = sample_texture(
            mat.roughness, u, v, uv_tile
        ).astype(np.float32)
    if mat.displacement is not None:
        h = sample_texture(mat.displacement, u, v, uv_tile)
        pts = pts + (h[:, None] - 0.5) * displacement_scale * nrm
    if mat.normal is not None:
        tn = sample_texture(mat.normal, u, v, uv_tile) * 2.0 - 1.0
        t, b, n = _tangent_frame(nrm)
        pert = (
            tn[:, 0:1] * t * normal_strength
            + tn[:, 1:2] * b * normal_strength
            + np.maximum(tn[:, 2:3], 0.1) * n
        )
        pert /= np.maximum(np.linalg.norm(pert, axis=1, keepdims=True),
                           1e-12)
        out["normals"] = pert.astype(np.float32)
    out["points"] = pts.astype(np.float32)
    return out


# ---- hue-shift recolor (change_texture_color, all_rendering.py:1083-1134) ----


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized RGB→HSV, all in [0,1] (h in [0,1))."""
    rgb = np.asarray(rgb, np.float64)
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    d = mx - mn
    safe = np.where(d > 0, d, 1.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.where(
        mx == r, (g - b) / safe % 6.0,
        np.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = np.where(d > 0, h / 6.0, 0.0)
    s = np.where(mx > 0, d / np.where(mx > 0, mx, 1.0), 0.0)
    return np.stack([h, s, mx], axis=-1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0] % 1.0, hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int64) % 6)[..., None]
    rgb = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [
            np.stack([v, t, p], -1), np.stack([q, v, p], -1),
            np.stack([p, v, t], -1), np.stack([p, q, v], -1),
            np.stack([t, p, v], -1), np.stack([v, p, q], -1),
        ],
    )
    return rgb


def hue_shift_colors(
    colors: np.ndarray,
    target_rgb,
    move_ratio: float = 0.8,
    mean_rgb=None,
) -> np.ndarray:
    """Shift hues toward ``target_rgb`` by ``move_ratio`` of the hue gap
    between the colors' mean hue (or ``mean_rgb``'s) and the target's —
    the reference's texture recolor semantics (:1104-1121)."""
    hsv = rgb_to_hsv(colors)
    target_h = float(rgb_to_hsv(np.asarray(target_rgb, np.float64))[0])
    if mean_rgb is not None:
        mean_h = float(rgb_to_hsv(np.asarray(mean_rgb, np.float64))[0])
    else:
        mean_h = float(hsv[..., 0].mean())
    hsv[..., 0] = (hsv[..., 0] + move_ratio * (target_h - mean_h)) % 1.0
    return hsv_to_rgb(hsv).astype(np.float32)
