"""Spherical-harmonics rotation.

Counterpart of ``autovfx_tpu/core/sh_rotation.py``.  For a rotation R
the (K, K) change-of-coefficients matrix M solves ``B M = B_rot`` by
least squares over 4K well-spread directions, where B[i, k] = Y_k(d_i)
and B_rot[i, k] = Y_k(R⁻¹ d_i): exact for band-limited functions (the
basis is full rank), with no per-band recurrences.
"""
from __future__ import annotations

import numpy as np
import torch

from autovfx_tpu_torch.core import sh as sh_lib


def _fibonacci_dirs(n: int = 64) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
         np.cos(phi)],
        axis=-1,
    )


def _basis(dirs: np.ndarray, degree: int = 3) -> np.ndarray:
    """(D, K) real SH basis in ``core.sh.eval_sh``'s convention: row k
    of the identity as the coefficients."""
    k = sh_lib.num_sh_coeffs(degree)
    d = len(dirs)
    coeffs = torch.eye(k)[:, None, :, None].expand(k, d, k, 3)
    dirs_t = torch.tensor(np.asarray(dirs, np.float32))
    vals = sh_lib.eval_sh(degree, coeffs, dirs_t.expand(k, d, 3))
    return vals[..., 0].T.double().numpy()


def sh_rotation_matrix(rot: np.ndarray, degree: int = 3) -> np.ndarray:
    """(K, K) matrix M with c' = M @ c for world rotation ``rot``."""
    dirs = _fibonacci_dirs(4 * sh_lib.num_sh_coeffs(degree))
    b = _basis(dirs, degree)
    b_rot = _basis(dirs @ rot, degree)  # rows: Y(R^-1 d) = Y(d @ R)
    m, *_ = np.linalg.lstsq(b, b_rot, rcond=None)
    return m.astype(np.float32)


def rotate_sh(sh_coeffs: torch.Tensor, rot: np.ndarray) -> torch.Tensor:
    """Rotate (N, K, 3) SH coefficients by one rotation matrix; bands
    above 3 are kept as they are."""
    k = sh_coeffs.shape[1]
    degree = int(round(k**0.5)) - 1
    m = torch.tensor(sh_rotation_matrix(np.asarray(rot), min(degree, 3)),
                     device=sh_coeffs.device)
    km = m.shape[0]
    head = torch.einsum("kj,njc->nkc", m, sh_coeffs[:, :km])
    return torch.cat([head, sh_coeffs[:, km:]], dim=1)
