"""Scene pose alignment: gravity-align, center and normalize.

Counterpart of ``autovfx_tpu/dataset/alignment.py`` (itself
``dataset_utils/colmap_runner.py``): the RANSAC mean ground normal
(:258-273: 100 iterations, 10k samples, cos > 0.99), the iterative
Rodrigues rotation of the up vector onto +z (:275-286) and the pose
centering and scaling into the unit cube (:288-304).  Numpy, with the
same seeded ``RandomState`` draws, so it gives the JAX package's
answers exactly.
"""
from __future__ import annotations

import numpy as np


def ransac_mean_normal(
    normals: np.ndarray,
    iters: int = 100,
    sample_size: int = 10_000,
    cos_thresh: float = 0.99,
    seed: int = 0,
) -> np.ndarray:
    """Robust dominant normal among candidate ground normals (N, 3)."""
    n = np.asarray(normals, np.float64)
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    rng = np.random.RandomState(seed)
    best_inliers = -1
    best = n.mean(0)
    for _ in range(iters):
        cand = n[rng.randint(len(n))]
        take = n[rng.choice(len(n), min(sample_size, len(n)), replace=False)]
        cos = take @ cand
        inl = int((cos > cos_thresh).sum())
        if inl > best_inliers:
            best_inliers = inl
            mask = (n @ cand) > cos_thresh
            best = n[mask].mean(0)
    return best / max(np.linalg.norm(best), 1e-12)


def rodrigues(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    k = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def up_alignment_rotation(
    up: np.ndarray, target=np.array([0.0, 0.0, 1.0]), iters: int = 4
) -> np.ndarray:
    """Iterative Rodrigues alignment of ``up`` to +z
    (colmap_runner.py:275-286)."""
    r_total = np.eye(3)
    up = np.asarray(up, np.float64)
    for _ in range(iters):
        cur = r_total @ up
        cur = cur / max(np.linalg.norm(cur), 1e-12)
        axis = np.cross(cur, target)
        s = np.linalg.norm(axis)
        if s < 1e-9:
            break
        angle = np.arcsin(np.clip(s, -1, 1))
        if np.dot(cur, target) < 0:
            angle = np.pi - angle
        r_total = rodrigues(axis, angle) @ r_total
    return r_total


def normalize_poses(
    c2ws: np.ndarray, up: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, float]:
    """Gravity-align, center, and scale camera poses into the unit cube
    (colmap_runner.py:275-304).

    Returns (aligned c2ws (F,4,4), world rotation applied, scale applied).
    """
    c2ws = np.asarray(c2ws, np.float64)
    if up is None:
        # default up estimate: negative mean camera-down axis (OpenCV +y
        # is down in camera frame)
        up = -c2ws[:, :3, 1].mean(0)
    r = up_alignment_rotation(up)
    out = c2ws.copy()
    out[:, :3, :3] = r[None] @ c2ws[:, :3, :3]
    out[:, :3, 3] = c2ws[:, :3, 3] @ r.T

    center = out[:, :3, 3].mean(0)
    out[:, :3, 3] -= center
    scale = float(np.abs(out[:, :3, 3]).max())
    scale = max(scale, 1e-9)
    out[:, :3, 3] /= scale
    return out.astype(np.float32), r.astype(np.float32), scale
