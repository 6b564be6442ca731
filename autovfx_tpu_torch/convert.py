"""Carry scene parameters into the port as tensors.

Takes plain arrays (``np.asarray`` of each field of another package's
``Gaussians`` or ``Camera``), as a dict or as keyword arguments, and
returns this package's dataclasses on a chosen device.  Only arrays
cross the boundary, so nothing here imports another framework.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core.cameras import Camera
from autovfx_tpu_torch.core.gaussians import Gaussians

GAUSSIAN_FIELDS = tuple(f.name for f in dataclasses.fields(Gaussians))
CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(Camera))
_FLOAT_FIELDS = tuple(f for f in GAUSSIAN_FIELDS if f != "active")


def _collect(cls, arrays: Optional[Mapping], fields: dict) -> dict:
    merged = dict(arrays or {}, **fields)
    names = {f.name for f in dataclasses.fields(cls)}
    if set(merged) != names:
        raise ValueError(
            f"{cls.__name__} needs exactly {sorted(names)}, got {sorted(merged)}"
        )
    return merged


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def gaussians(
    arrays: Optional[Mapping] = None, *, device="cpu", **fields
) -> Gaussians:
    """Gaussians from arrays named like its fields (float32; ``active``
    becomes bool)."""
    a = _collect(Gaussians, arrays, fields)
    out = {name: _f32(a[name], device) for name in _FLOAT_FIELDS}
    out["active"] = torch.tensor(np.asarray(a["active"], dtype=bool),
                                 device=device)
    return Gaussians(**out)


def camera(arrays: Optional[Mapping] = None, *, device="cpu", **fields) -> Camera:
    """Camera from arrays ``R, t, fx, fy, cx, cy`` and ints ``width, height``."""
    a = _collect(Camera, arrays, fields)
    return Camera(
        **{name: _f32(a[name], device) for name in ("R", "t", "fx", "fy",
                                                    "cx", "cy")},
        width=int(a["width"]),
        height=int(a["height"]),
    )
