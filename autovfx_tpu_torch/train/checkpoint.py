"""Training checkpoints: the whole ``TrainState`` in one ``.npz``.

Counterpart of ``autovfx_tpu/train/checkpoint.py`` with the same key
names (``g_*``, ``m_*``, ``v_*`` for the Gaussians and the two Adam
moments, ``adam_count``, ``stats_*``, ``step``), so a checkpoint written
by either package loads in the other.  ``save_snapshot`` adds the
reference's ``point_cloud/iteration_N/point_cloud.ply`` beside
``chkpntN.npz``.
"""
from __future__ import annotations

import os

import numpy as np

from autovfx_tpu_torch import convert
from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core import ply_io
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.train.trainer import TrainState


def _gaussian_arrays(g: Gaussians, prefix: str) -> dict:
    return {f"{prefix}{f}": getattr(g, f).detach().cpu().numpy()
            for f in convert.GAUSSIAN_FIELDS}


def state_arrays(state: TrainState) -> dict:
    """The checkpoint's arrays of ``state``."""
    out = {}
    out.update(_gaussian_arrays(state.gaussians, "g_"))
    out.update(_gaussian_arrays(state.adam.m, "m_"))
    out.update(_gaussian_arrays(state.adam.v, "v_"))
    out["adam_count"] = np.asarray(state.adam.count, np.int32)
    for f in ("grad_accum", "denom", "max_radii"):
        out[f"stats_{f}"] = getattr(state.stats, f).cpu().numpy()
    out["step"] = np.asarray(state.step, np.int32)
    return out


def save_checkpoint(path: str, state: TrainState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **state_arrays(state))


def load_checkpoint(path: str, device=devices.DEFAULT) -> TrainState:
    device = devices.resolve(device)
    with np.load(path) as d:
        return convert.train_state(dict(d), device=device)


def save_snapshot(model_dir: str, state: TrainState, iteration: int,
                  with_ply: bool = True) -> str:
    """``chkpntN.npz`` and, with ``with_ply``, the reference's PLY layout
    ``point_cloud/iteration_N/point_cloud.ply``; returns the checkpoint
    path."""
    ckpt = os.path.join(model_dir, f"chkpnt{iteration}.npz")
    save_checkpoint(ckpt, state)
    if with_ply:
        ply_dir = os.path.join(model_dir, "point_cloud", f"iteration_{iteration}")
        os.makedirs(ply_dir, exist_ok=True)
        ply_io.save_ply(os.path.join(ply_dir, "point_cloud.ply"),
                        state.gaussians)
    return ckpt
