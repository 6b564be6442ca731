"""The Gaussian splat store: a dataclass of tensors with an ``active`` mask.

Counterpart of ``autovfx_tpu/core/gaussians.py`` (activations :64-122,
``create`` / ``pad_to`` / ``compact`` :126-201, ``merge`` :251).
Fields keep the JAX package's layouts: ``xyz`` (N, 3), ``sh_dc`` (N, 3),
``sh_rest`` (N, K-1, 3), ``log_scales`` (N, 3), ``quats`` (N, 4) wxyz,
``opacity_logit`` (N,), ``active`` (N,) bool.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import quaternion, sh as sh_lib

# the trained fields (every field but ``active``)
PARAM_FIELDS = ("xyz", "sh_dc", "sh_rest", "log_scales", "quats",
                "opacity_logit")


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

    @property
    def num_active(self) -> torch.Tensor:
        """() int64 count of active slots (a tensor: no host sync)."""
        return self.active.sum()

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

    # ---- construction / resizing ----------------------------------------------

    @classmethod
    def create(
        cls,
        xyz: torch.Tensor,
        rgb: Optional[torch.Tensor] = None,
        sh_degree: int = 3,
        initial_scale: Optional[torch.Tensor] = None,
        initial_opacity: float = 0.1,
    ) -> "Gaussians":
        """Initialize from a point cloud: DC from RGB (0.5 grey when not
        given), isotropic scale ``initial_scale`` (default 0.01), identity
        rotation, opacity ``initial_opacity``."""
        n, dev = xyz.shape[0], xyz.device
        f32 = torch.float32
        k = (sh_degree + 1) ** 2
        if rgb is None:
            rgb = torch.full((n, 3), 0.5, dtype=f32, device=dev)
        if initial_scale is None:
            log_scales = torch.full((n, 3), float(np.log(0.01)), dtype=f32,
                                    device=dev)
        else:
            log_scales = torch.log(torch.clamp(initial_scale, min=1e-7)).to(f32)
            if log_scales.ndim == 1:
                log_scales = log_scales[:, None].repeat(1, 3)
        quats = torch.zeros((n, 4), dtype=f32, device=dev)
        quats[:, 0] = 1.0
        op = float(np.log(initial_opacity / (1.0 - initial_opacity)))
        return cls(
            xyz=xyz.to(f32),
            sh_dc=sh_lib.rgb_to_sh(rgb.to(f32)),
            sh_rest=torch.zeros((n, k - 1, 3), dtype=f32, device=dev),
            log_scales=log_scales,
            quats=quats,
            opacity_logit=torch.full((n,), op, dtype=f32, device=dev),
            active=torch.ones((n,), dtype=torch.bool, device=dev),
        )

    def pad_to(self, capacity: int) -> "Gaussians":
        """Grow to ``capacity`` slots; the new ones are inactive, with an
        identity rotation and opacity logit -10."""
        n = self.capacity
        if capacity < n:
            raise ValueError(f"cannot shrink capacity {n} -> {capacity}")
        if capacity == n:
            return self
        extra = capacity - n

        def pad(x):
            return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

        quats = pad(self.quats)
        quats[n:, 0] = 1.0
        logit = pad(self.opacity_logit)
        logit[n:] = -10.0
        return dataclasses.replace(
            self, xyz=pad(self.xyz), sh_dc=pad(self.sh_dc),
            sh_rest=pad(self.sh_rest), log_scales=pad(self.log_scales),
            quats=quats, opacity_logit=logit, active=pad(self.active),
        )

    def compact(self) -> "Gaussians":
        """Drop the inactive slots (the capacity changes: between steps)."""
        idx = torch.nonzero(self.active)[:, 0]
        return Gaussians(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)})


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
