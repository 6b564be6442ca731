"""Run one function on every rank of a fresh ``torch.distributed`` world.

``spawn(world, fn, args, backend=..., device=...)`` starts ``world``
processes with the ``spawn`` start method (a process that has touched
CUDA must not ``fork``), joins them through a ``FileStore`` in a
temporary directory (no port to collide on), and calls
``fn(rank, world, *args)`` in each after ``init_process_group``.  ``fn``
must be importable by name in a fresh interpreter, and its result
picklable: the ranks hand back numpy arrays and numbers.  On the card
the kernel library is built once here, before the ranks start, and the
ranks only load it.

If a rank raises, the others are stopped and ``spawn`` raises with that
rank's traceback.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import traceback
from multiprocessing.connection import wait

import torch
import torch.distributed as dist

from autovfx_tpu_torch.core import device as devices

TIMEOUT_S = 1800.0


def _rank_entry(rank, world, store, backend, device, fn, args, out):
    """One rank: its process group, ``fn``, its result (or its
    traceback) pickled to ``out``."""
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        else:
            torch.cuda.set_device(dev)
            from autovfx_tpu_torch.ops import _build

            _build.load_library()
        dist.init_process_group(backend, store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        try:
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if result[0] == "error":
        raise SystemExit(1)


def spawn(world: int, fn, args: tuple = (), *, backend: str,
          device=devices.DEFAULT) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own process on ``device`` (each rank's ``init_process_group`` with
    ``backend``); raises if the ranks run past ``TIMEOUT_S`` (a rank
    stuck in a collective)."""
    dev = devices.resolve(device)
    if dev.type == "cuda":
        from autovfx_tpu_torch.ops import _build

        _build.build()
        if dev.index is None:  # the ranks share the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_entry, args=(
            r, world, os.path.join(tmp, "store"), backend, str(dev), fn,
            tuple(args), outs[r])) for r in range(world)]
        for p in procs:
            p.start()
        try:
            pending = {p.sentinel: p for p in procs}
            while pending:
                ready = wait(list(pending), TIMEOUT_S)
                if not ready:
                    raise TimeoutError(f"ranks still running after "
                                       f"{TIMEOUT_S} s")
                for s in ready:
                    p = pending.pop(s)
                    p.join()
                    if p.exitcode != 0:
                        raise RuntimeError(_failure(procs, outs))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f)[1])
        return results


def _failure(procs, outs) -> str:
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.exitcode not in (None, 0) and os.path.exists(out):
            with open(out, "rb") as f:
                status, text = pickle.load(f)
            if status == "error":
                return f"rank {r} failed:\n{text}"
    codes = [p.exitcode for p in procs]
    return f"a rank exited without a result (exit codes {codes})"
