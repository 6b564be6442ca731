"""Carry scene parameters and training state into the port as tensors.

Takes plain arrays (``np.asarray`` of each field of another package's
``Gaussians`` or ``Camera``), as a dict or as keyword arguments, and
returns this package's dataclasses on a chosen device; ``train_state``
takes a whole training state in the arrays of a checkpoint.  Only
arrays cross the boundary, so nothing here imports another framework.
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


def train_state(arrays: Mapping, *, device="cpu"):
    """A ``train.trainer.TrainState`` from the arrays of a training state,
    named as in a checkpoint ``.npz`` of either package: ``g_<field>``,
    ``m_<field>`` and ``v_<field>`` for the Gaussians and the two Adam
    moments, ``adam_count``, ``stats_grad_accum``, ``stats_denom``,
    ``stats_max_radii`` and ``step``.  The moments' ``active`` arrays are
    read as bool (they are zeros)."""
    from autovfx_tpu_torch.train.densify import DensifyStats
    from autovfx_tpu_torch.train.trainer import AdamState, TrainState

    def gauss(prefix):
        return gaussians({f: arrays[prefix + f] for f in GAUSSIAN_FIELDS},
                         device=device)

    return TrainState(
        gaussians=gauss("g_"),
        adam=AdamState(m=gauss("m_"), v=gauss("v_"),
                       count=int(arrays["adam_count"])),
        stats=DensifyStats(
            grad_accum=_f32(arrays["stats_grad_accum"], device),
            denom=_f32(arrays["stats_denom"], device),
            max_radii=torch.tensor(
                np.asarray(arrays["stats_max_radii"], dtype=np.int32),
                device=device),
        ),
        step=int(arrays["step"]),
    )
