"""Carry scene parameters and training state into the port as tensors.

Takes plain arrays (``np.asarray`` of each field of another package's
``Gaussians`` or ``Camera``), as a dict or as keyword arguments, and
returns this package's dataclasses on a chosen device; ``train_state``
takes a whole training state in the arrays of a checkpoint,
``clip_inputs`` an edited clip's inputs (with its smoke volume and melt
tracers), ``slabs`` one rank's piece of per-device stacked Gaussians,
``bound_gaussians`` refined SuGaR's mesh-bound Gaussians,
``lpips_params`` the LPIPS network's weights and
``lama_params_from_jax`` the LaMa generator's.  Only
arrays cross the boundary, so nothing here imports another framework.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
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
    arrays: Optional[Mapping] = None, *, device=devices.DEFAULT, **fields
) -> Gaussians:
    """Gaussians from arrays named like its fields (float32; ``active``
    becomes bool)."""
    device = devices.resolve(device)
    a = _collect(Gaussians, arrays, fields)
    out = {name: _f32(a[name], device) for name in _FLOAT_FIELDS}
    out["active"] = torch.tensor(np.asarray(a["active"], dtype=bool),
                                 device=device)
    return Gaussians(**out)


def slabs(arrays: Mapping, rank: int, *, device=devices.DEFAULT) -> Gaussians:
    """Rank ``rank``'s Gaussians from per-device stacked arrays named like
    the fields, each (D, cap, ...): the JAX package's depth slabs
    (``shard_gaussians``, ``shard_gaussians_compact``,
    ``distributed_shard_compact``) or a ``round_robin_store``."""
    a = _collect(Gaussians, arrays, {})
    return gaussians({f: np.asarray(a[f])[rank] for f in GAUSSIAN_FIELDS},
                     device=device)


def camera(arrays: Optional[Mapping] = None, *, device=devices.DEFAULT,
           **fields) -> Camera:
    """Camera from arrays ``R, t, fx, fy, cx, cy`` and ints ``width, height``."""
    device = devices.resolve(device)
    a = _collect(Camera, arrays, fields)
    return Camera(
        **{name: _f32(a[name], device) for name in ("R", "t", "fx", "fy",
                                                    "cx", "cy")},
        width=int(a["width"]),
        height=int(a["height"]),
    )


def train_state(arrays: Mapping, *, device=devices.DEFAULT):
    """A ``train.trainer.TrainState`` from the arrays of a training state,
    named as in a checkpoint ``.npz`` of either package: ``g_<field>``,
    ``m_<field>`` and ``v_<field>`` for the Gaussians and the two Adam
    moments, ``adam_count``, ``stats_grad_accum``, ``stats_denom``,
    ``stats_max_radii`` and ``step``.  The moments' ``active`` arrays are
    read as bool (they are zeros)."""
    device = devices.resolve(device)
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


def clip_inputs(arrays: Mapping, bg: Gaussians, cams: Camera, *,
                device=devices.DEFAULT):
    """A ``render.clip.ClipInputs`` from arrays named like its fields
    (``surf_*``, ``traj_*``, ``hull_planes``, ``hull_mask``, ``env``,
    ``env_sh``, ``light_dirs``, ``light_weights`` and, optionally,
    ``env_ggx``, the ``smoke_*`` volume and the ``melt_*`` tracers) and
    the background and stacked cameras already carried over.
    ``surf_body`` becomes int64, ``smoke_origin_cells`` int32, and
    ``hull_mask`` and ``melt_mask`` bool."""
    device = devices.resolve(device)
    from autovfx_tpu_torch.render.clip import ClipInputs

    ints = {"surf_body": torch.int64, "hull_mask": torch.bool,
            "smoke_origin_cells": torch.int32, "melt_mask": torch.bool}
    names = [f.name for f in dataclasses.fields(ClipInputs)
             if f.name not in ("bg", "cams")]
    out = {}
    for name in names:
        if arrays.get(name) is None:
            continue
        dt = ints.get(name, torch.float32)
        out[name] = torch.tensor(np.asarray(arrays[name]), device=device).to(dt)
    return ClipInputs(bg=bg, cams=cams, **out)


def bound_gaussians(arrays: Mapping, *, device=devices.DEFAULT):
    """A ``sugar.refine.BoundGaussians`` from arrays named like its
    fields (``vertices``, ``faces``, ``bary``, ``log_scales2d``,
    ``rot_complex``, ``vertex_colors``, ``opacity_logit`` and, optionally,
    the float ``thickness_ratio``); ``faces`` becomes int64."""
    from autovfx_tpu_torch.sugar.refine import BoundGaussians

    device = devices.resolve(device)
    out = {f.name: _f32(arrays[f.name], device)
           for f in dataclasses.fields(BoundGaussians)
           if f.name not in ("faces", "thickness_ratio")}
    out["faces"] = torch.tensor(np.asarray(arrays["faces"], np.int64),
                                device=device)
    if arrays.get("thickness_ratio") is not None:
        out["thickness_ratio"] = float(arrays["thickness_ratio"])
    return BoundGaussians(**out)


def lpips_params(convs, lins, source: str, *, device=devices.DEFAULT):
    """A ``utils.lpips.LPIPSParams`` from the JAX package's LPIPS weights:
    ``convs`` a sequence of (w, b) with ``w`` (3, 3, in, out) (HWIO;
    this package's convolutions are OIHW), ``lins`` the five heads' (C,)
    weights, ``source`` "file" or "random"."""
    from autovfx_tpu_torch.utils.lpips import LPIPSParams

    device = devices.resolve(device)
    out = []
    for w, b in convs:
        w = np.asarray(w, np.float32).transpose(3, 2, 0, 1)  # -> OIHW
        out.append((_f32(w, device), _f32(b, device)))
    return LPIPSParams(convs=tuple(out),
                       lins=tuple(_f32(x, device) for x in lins),
                       source=str(source))


def lama_params_from_jax(params, *, device=devices.DEFAULT):
    """A ``perception.lama.LamaParams`` from the JAX package's converted
    LaMa weights (its ``LamaParams`` with numpy leaves, read by
    attribute): the HWIO convolutions become OIHW, the transposed
    convolutions' pre-flipped HWIO kernels torch's (I, O, kh, kw) again,
    and each folded BatchNorm's (C,) scale and shift (C, 1, 1)."""
    from autovfx_tpu_torch.perception.lama import LamaParams

    device = devices.resolve(device)
    oihw = lambda w: _f32(np.asarray(w, np.float32).transpose(3, 2, 0, 1),
                          device)
    bn = lambda p: None if p is None else tuple(
        _f32(x, device)[:, None, None] for x in p)

    def ffc(p):
        out = {k: None if p[k] is None else oihw(p[k])
               for k in ("l2l", "l2g", "g2l")}
        g = p["g2g"]
        out["g2g"] = None if g is None else {
            "conv1": oihw(g["conv1"]), "bn1": bn(g["bn1"]),
            "fu": oihw(g["fu"]), "fu_bn": bn(g["fu_bn"]),
            "conv2": oihw(g["conv2"])}
        out.update(bn_l=bn(p["bn_l"]), bn_g=bn(p["bn_g"]))
        return out

    def up(u):
        w = np.asarray(u["w"], np.float32).transpose(2, 3, 0, 1)
        return {"w": _f32(w[:, :, ::-1, ::-1].copy(), device),
                "b": _f32(u["b"], device), "bn": bn(u["bn"])}

    return LamaParams(
        init=ffc(params.init), down=[ffc(d) for d in params.down],
        blocks=[{k: ffc(b[k]) for k in ("conv1", "conv2")}
                for b in params.blocks],
        up=[up(u) for u in params.up], out_w=oihw(params.out_w),
        out_b=_f32(params.out_b, device))
