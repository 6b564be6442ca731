"""A multi-rank dry run of the parallel layer at tiny shapes.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:30-230``): ``dryrun_multichip(n, device)`` spawns
``n`` ranks (``parallel.launch.spawn``) that

1. take one DP training step over an (n, 1) mesh from a perturbed copy
   of a tiny scene toward its renders (the loss must be nonzero and the
   parameters must move), and check a step over a 1-rank mesh against
   the sequential ``trainer.train_step``;
2. render the scene in depth slabs over a (1, n) mesh: full-capacity
   slabs (``sharded_render``), compact slabs (``sharded_render_compact``)
   and slabs built from a striped store (``distributed_shard_compact``),
   each against the single-rank ``rasterize``.

Any mismatch raises.  Run it as ``python -m
autovfx_tpu_torch.parallel.dryrun [n] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.parallel import launch
from autovfx_tpu_torch.parallel import sharding as S
from autovfx_tpu_torch.parallel.mesh import make_mesh
from autovfx_tpu_torch.train import trainer as T
from autovfx_tpu_torch.utils.synthetic import make_gaussians

CONFIG = RasterConfig(dup_budget=1 << 12)
# the JAX package's bounds (tests/test_parallel.py:47-66, and the dry
# run's 1e-5 on the 1-rank step and 5e-3 between the two slab builds)
COLOR_ATOL, DEPTH_ATOL, STEP_ATOL, BUILD_MEAN_ERR = 2e-3, 5e-3, 1e-5, 5e-3


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def _dryrun_rank(rank: int, world: int, backend: str, device: str) -> dict:
    dev = torch.device(device)
    g = make_gaussians(64, np.random.default_rng(0), device=dev)
    cams = C.stack_cameras([
        C.look_at_camera([2 * np.cos(a), 2 * np.sin(a), 1.0], [0, 0, 0],
                         [0, 0, 1], fx=14.0, fy=14.0, width=32, height=16,
                         device=dev)
        for a in np.linspace(0, 2 * np.pi, world, endpoint=False)])
    with torch.no_grad():
        imgs = torch.stack([rasterize(g, C.index_camera(cams, i),
                                      config=CONFIG).color
                            for i in range(world)])

    # 1) the DP step from a perturbed copy, so that real (nonzero)
    # gradients cross the collectives
    noise = np.random.default_rng(7).standard_normal((g.capacity, 3))
    g_train = dataclasses.replace(
        g, xyz=g.xyz + 0.02 * torch.as_tensor(noise, dtype=torch.float32,
                                              device=dev),
        opacity_logit=g.opacity_logit - 0.3)
    cfg = T.TrainConfig(raster=CONFIG)
    mesh_dp = make_mesh((world, 1), backend=backend, device=dev)
    state, aux = S.dp_train_step(T.init_state(g_train),
                                 C.index_camera(cams, rank), imgs[rank], cfg,
                                 mesh_dp)
    loss = float(aux.loss)
    _require(np.isfinite(loss) and loss > 1e-5,
             f"the DP loss must be finite and nonzero, got {loss}")
    dxyz = float((state.gaussians.xyz - g_train.xyz).abs().max())
    _require(dxyz > 0.0, "the DP step must move the parameters")
    # a 1-rank mesh against the sequential trainer
    mesh_1 = make_mesh((1, 1), backend=backend, device=dev, ranks=[0])
    if mesh_1 is not None:
        cam0 = C.index_camera(cams, 0)
        one, _ = S.dp_train_step(T.init_state(g_train), cam0, imgs[0], cfg,
                                 mesh_1)
        seq, _ = T.train_step(T.init_state(g_train), cam0, imgs[0], cfg)
        err = float((one.gaussians.xyz - seq.gaussians.xyz).abs().max())
        _require(err <= STEP_ATOL, f"1-rank mesh vs the sequential "
                 f"trainer: max |dxyz| {err}")
    out = {"loss": loss, "dxyz": dxyz}

    # 2) depth slabs over the model axis
    if world >= 2:
        mesh_g = make_mesh((1, world), backend=backend, device=dev)
        cam0 = C.index_camera(cams, 0)
        with torch.no_grad():
            ref = rasterize(g, cam0, config=CONFIG)
            full = S.sharded_render(S.shard_gaussians(g, cam0, world, rank),
                                    cam0, mesh_g, config=CONFIG)
            compact, ovf = S.shard_gaussians_compact(g, cam0, world, rank)
            _require(not bool(ovf), "the compact slabs overflowed")
            comp = S.sharded_render_compact(compact, cam0, mesh_g,
                                            config=CONFIG)
            store = S.round_robin_store(g, world, rank)
            slabs, ovf = S.distributed_shard_compact(store, cam0, mesh_g,
                                                     slack=0.6)
            _require(not bool(ovf), "the distributed slab build overflowed")
            built = S.sharded_render_compact(slabs, cam0, mesh_g,
                                             config=CONFIG)
        for name, (color, depth, alpha) in (("full", full), ("compact", comp),
                                            ("distributed", built)):
            e = [float((a - b).abs().max()) for a, b in (
                (color, ref.color), (alpha, ref.alpha), (depth, ref.depth))]
            _require(e[0] <= COLOR_ATOL and e[1] <= COLOR_ATOL
                     and e[2] <= DEPTH_ATOL,
                     f"{name} slabs vs rasterize: color, alpha, depth max "
                     f"err {e}")
            out[name] = e
        d_err = float((built[0] - comp[0]).abs().mean())
        _require(d_err < BUILD_MEAN_ERR, f"distributed vs replicated slab "
                 f"build: mean |dC| {d_err}")
        out["build_mean_err"] = d_err
    return out


def dryrun_multichip(n_ranks: int, device=devices.DEFAULT) -> dict:
    """The dry run on ``n_ranks`` gloo ranks computing on ``device`` (gloo
    serves the CPU and ranks that share a card alike).  Returns rank 0's
    numbers; raises on any mismatch."""
    dev = devices.resolve(device)
    res = launch.spawn(n_ranks, _dryrun_rank, ("gloo", str(dev)),
                       backend="gloo", device=dev)[0]
    print(f"dryrun_multichip OK: {n_ranks}-rank DP train step (loss="
          f"{res['loss']:.4f} > 0, max|dxyz|={res['dxyz']:.2e}, 1-rank "
          f"mesh == sequential trainer)"
          + (f" + {n_ranks}-slab sharded renders (full, compact, "
             f"distributed; mean|dC| between builds "
             f"{res['build_mean_err']:.1e})" if n_ranks >= 2 else ""))
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n_ranks", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=devices.DEFAULT)
    a = ap.parse_args()
    dryrun_multichip(a.n_ranks, a.device)
