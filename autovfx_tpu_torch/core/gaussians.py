"""The Gaussian splat store: a dataclass of tensors with an ``active`` mask.

Counterpart of ``autovfx_tpu/core/gaussians.py`` (activations :64-122,
``merge`` :251).  Fields keep the JAX package's layouts: ``xyz`` (N, 3),
``sh_dc`` (N, 3), ``sh_rest`` (N, K-1, 3), ``log_scales`` (N, 3),
``quats`` (N, 4) wxyz, ``opacity_logit`` (N,), ``active`` (N,) bool.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from autovfx_tpu_torch.core import quaternion, sh as sh_lib


@dataclasses.dataclass(frozen=True)
class Gaussians:
    """A batch of 3D Gaussians; inactive slots render fully transparent."""

    xyz: torch.Tensor
    sh_dc: torch.Tensor
    sh_rest: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logit: torch.Tensor
    active: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        k = 1 + self.sh_rest.shape[1]
        return int(round(k**0.5)) - 1

    # ---- activations ----------------------------------------------------------

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logit) * self.active.to(
            self.opacity_logit.dtype
        )

    @property
    def rotations(self) -> torch.Tensor:
        return quaternion.quat_normalize(self.quats)

    @property
    def sh(self) -> torch.Tensor:
        """(N, K, 3) full SH coefficient tensor (DC first)."""
        return torch.cat([self.sh_dc[:, None, :], self.sh_rest], dim=1)

    def colors(
        self, campos: torch.Tensor, degree: Optional[int] = None
    ) -> torch.Tensor:
        """(N, 3) view-dependent RGB from SH toward ``campos``; bands
        above 3 are never evaluated."""
        deg = min(self.sh_degree if degree is None else degree, 3)
        dirs = self.xyz - campos[None, :]
        dirs = dirs / torch.clamp(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12
        )
        return sh_lib.sh_to_rgb(deg, self.sh, dirs)

    def normals(self, view_dirs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-Gaussian normal = min-scale axis, flipped so that
        dot(normal, view_dir) <= 0 when ``view_dirs`` is given."""
        rot = quaternion.quat_to_rotmat(self.rotations)  # columns = axes
        idx = torch.argmin(self.log_scales, dim=-1)
        n = torch.take_along_dim(rot, idx[:, None, None].expand(-1, 3, 1), dim=2)[
            ..., 0
        ]
        if view_dirs is not None:
            flip = torch.sum(n * view_dirs, dim=-1, keepdim=True) > 0
            n = torch.where(flip, -n, n)
        return n


def merge(a: Gaussians, b: Gaussians) -> Gaussians:
    """Concatenate two splat clouds; the lower SH degree is zero-padded."""
    ka, kb = a.sh_rest.shape[1], b.sh_rest.shape[1]

    def pad_rest(g: Gaussians, k: int) -> Gaussians:
        extra = g.sh_rest.new_zeros((g.capacity, k - g.sh_rest.shape[1], 3))
        return dataclasses.replace(g, sh_rest=torch.cat([g.sh_rest, extra], 1))

    if ka < kb:
        a = pad_rest(a, kb)
    elif kb < ka:
        b = pad_rest(b, ka)
    return Gaussians(
        **{f.name: torch.cat([getattr(a, f.name), getattr(b, f.name)], 0)
           for f in dataclasses.fields(Gaussians)}
    )
