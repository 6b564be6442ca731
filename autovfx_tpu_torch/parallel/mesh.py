"""Process meshes over ``torch.distributed`` and the collectives on them.

Counterpart of ``autovfx_tpu/parallel/mesh.py:20``.  The JAX package is
single-controller: one program holds ``(D, ...)`` stacked arrays and
``shard_map`` runs the per-device body.  This package is
multi-controller: every ``torch.distributed`` rank runs the same program
on its own piece, and a ``Mesh`` tells a rank where it sits.  The axes
are those of the JAX package:

- ``data``:  training cameras (gradients all-reduced over it);
- ``gauss``: the splat store, in view-depth slabs composited in order.

The caller starts the process group (``init_process_group`` with its
own address or store, world size and rank) and picks the backend:
``"nccl"`` for one card per rank, ``"gloo"`` for ranks that share a card
or run on the CPU (NCCL refuses two ranks on one card).

**The message rule.** A collective's message lives on the device of its
group's backend: the card for NCCL, the CPU for gloo.  ``_to_wire`` puts
a message there and each collective below brings its result back to the
device of the tensor it was given, so a gloo mesh of ranks that compute
on the card copies each message to the host and back, and an NCCL mesh
copies nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from autovfx_tpu_torch.core import device as devices

_BACKENDS = ("nccl", "gloo")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in a mesh of ranks.

    ``shape`` maps each axis to its size, in order; ``ranks`` are the
    mesh's global ranks in row-major order (``np.reshape`` of them to
    ``shape`` is the mesh); ``coords`` is this rank's index on each axis;
    ``groups[axis]`` is the process group of the ranks that share this
    rank's other coordinates, and ``group_ranks[axis]`` their global
    ranks in axis order.  ``device`` is where the rank computes."""

    shape: dict
    rank: int
    ranks: tuple
    coords: dict
    groups: dict
    group_ranks: dict
    backend: str
    device: torch.device

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position on ``axis`` (JAX's ``axis_index``)."""
        return self.coords[axis]

    @property
    def wire(self) -> torch.device:
        """The device of every message (the message rule)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "gauss"),
    *,
    backend: str,
    device=devices.DEFAULT,
    ranks: Optional[Sequence[int]] = None,
) -> Optional[Mesh]:
    """This rank's ``Mesh`` over the global ``ranks`` (default: the whole
    world, whose process group must be initialized), with one process
    group per axis made by ``dist.new_group`` with ``backend``.

    Every rank of the world must call it with the same arguments, since
    making a group is collective; a rank outside ``ranks`` gets None.
    Default shape: every rank on the first axis, 1 on the others."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, "
                         f"not {backend!r}")
    device = devices.resolve(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL mesh computes on the card: pass a CUDA "
                         "device, or use gloo")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's process "
                           "group: call init_process_group first")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} "
                         f"does not hold {n} ranks")
    grid = np.array(ranks).reshape(shape)
    me = dist.get_rank()
    groups, group_ranks = {}, {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in lines.tolist():
            group = dist.new_group(line, backend=backend)
            if me in line:
                groups[name], group_ranks[name] = group, tuple(line)
    if me not in ranks:
        return None
    where = np.argwhere(grid == me)[0]
    return Mesh(shape=dict(zip(axis_names, shape)), rank=me,
                ranks=tuple(ranks),
                coords={a: int(i) for a, i in zip(axis_names, where)},
                groups=groups, group_ranks=group_ranks, backend=backend,
                device=device)


# ---- collectives (each follows the message rule) -----------------------------


def _to_wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t.contiguous().to(mesh.wire)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str,
               op: str = "sum") -> torch.Tensor:
    """``psum`` / ``pmax`` / ``pmin`` of ``t`` over ``axis`` (``t`` may
    be reduced in place)."""
    msg = _to_wire(t, mesh)
    dist.all_reduce(msg, op=_OPS[op], group=mesh.groups[axis])
    return msg.to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``(D * t.shape[0], ...)``: every rank's ``t`` on ``axis``, in axis
    order (``all_gather(..., tiled=True)``)."""
    msg = _to_wire(t, mesh)
    out = msg.new_empty((mesh.size(axis) * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, msg, group=mesh.groups[axis])
    return out.to(t.device)


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``t`` (D * k, ...) sends rows ``[d k, (d + 1) k)`` to the rank at
    index d; returns the rows every rank sent here, in axis order."""
    msg = _to_wire(t, mesh)
    out = torch.empty_like(msg)
    dist.all_to_all_single(out, msg, group=mesh.groups[axis])
    return out.to(t.device)


def shift(t: torch.Tensor, mesh: Mesh, axis: str,
          step: int) -> Optional[torch.Tensor]:
    """``ppermute`` by ``step`` along ``axis``: sends ``t`` to the rank
    ``step`` places on (if there is one) and returns what the rank
    ``step`` places back sent (None at the first ``step`` places)."""
    me, line = mesh.index(axis), mesh.group_ranks[axis]
    group = mesh.groups[axis]
    ops, recv = [], None
    if me + step < len(line):
        ops.append(dist.P2POp(dist.isend, _to_wire(t, mesh), line[me + step],
                              group))
    if me >= step:
        recv = torch.empty(t.shape, dtype=t.dtype, device=mesh.wire)
        ops.append(dist.P2POp(dist.irecv, recv, line[me - step], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if recv is None else recv.to(t.device)


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str,
              src_index: int) -> torch.Tensor:
    """The ``t`` of the rank at ``src_index`` on ``axis``, on every rank
    of the group."""
    msg = _to_wire(t, mesh)
    dist.broadcast(msg, src=mesh.group_ranks[axis][src_index],
                   group=mesh.groups[axis])
    return msg.to(t.device)
