"""Quaternion / rotation utilities on tensors (wxyz, scalar first).

Counterpart of ``autovfx_tpu/core/quaternion.py``; the formulas are the
same so that covariances built from them agree to float32 rounding.
"""
from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions along the last axis."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion.

    Branch-free Shepperd's method: all four candidate solutions are
    built and the one with the largest pivot is selected per matrix.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    pivots = [
        safe_sqrt(1.0 + tr),
        safe_sqrt(1.0 + m00 - m11 - m22),
        safe_sqrt(1.0 - m00 + m11 - m22),
        safe_sqrt(1.0 - m00 - m11 + m22),
    ]
    rows = [
        [pivots[0], m21 - m12, m02 - m20, m10 - m01],
        [m21 - m12, pivots[1], m01 + m10, m02 + m20],
        [m02 - m20, m01 + m10, pivots[2], m12 + m21],
        [m10 - m01, m02 + m20, m12 + m21, pivots[3]],
    ]
    cands = []
    for i, row in enumerate(rows):
        q = torch.stack(row, dim=-1) / (2.0 * row[i][..., None])
        q[..., i] = pivots[i] / 2.0
        cands.append(q)
    cand = torch.stack(cands, dim=-2)  # (..., 4, 4)
    scores = torch.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1
    )
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.take_along_dim(cand, idx, dim=-2)[..., 0, :]
    return quat_normalize(q)
