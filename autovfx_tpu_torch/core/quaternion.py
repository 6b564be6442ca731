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


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def helper_axis(n: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per row of unit vectors ``n`` (..., 3): +z where |n_z| <
    ``threshold``, else +x (a tangent-frame helper), made on n's device
    with no copy from the host."""
    c = (torch.abs(n[..., 2]) < threshold).to(n.dtype)
    return torch.stack([1.0 - c, torch.zeros_like(c), c], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit axis, (...) angle in radians -> (..., 4) wxyz."""
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """Integrate orientation by world-frame angular velocity ``omega``:
    q' = normalize(q + dt/2 · (0, omega) ⊗ q)."""
    omega_q = torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1)
    dq = 0.5 * quat_multiply(omega_q, q)
    return quat_normalize(q + dt * dq)


def euler_to_rotmat(rx, ry, rz) -> torch.Tensor:
    """XYZ-order Euler angles (radians, Blender's default) -> (3, 3)
    float32 rotation ``Rz @ Ry @ Rx``."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)
    rx, ry, rz = f32(rx), f32(ry), f32(rz)
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    o, z = torch.ones_like(cx), torch.zeros_like(cx)
    rot_x = torch.stack([torch.stack([o, z, z]), torch.stack([z, cx, -sx]),
                         torch.stack([z, sx, cx])])
    rot_y = torch.stack([torch.stack([cy, z, sy]), torch.stack([z, o, z]),
                         torch.stack([-sy, z, cy])])
    rot_z = torch.stack([torch.stack([cz, -sz, z]), torch.stack([sz, cz, z]),
                         torch.stack([z, z, o])])
    return rot_z @ rot_y @ rot_x
