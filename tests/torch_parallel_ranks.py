"""The rank side of ``tests/test_torch_parallel.py``: every case of the
port's parallel layer, run in one spawned world of gloo ranks on the CPU.

It imports torch and the port only (the ranks never load JAX).  Its
inputs are numpy arrays made by the JAX side; it returns numpy.
"""
import dataclasses

import torch

from autovfx_tpu_torch import convert
from autovfx_tpu_torch.core.cameras import index_camera
from autovfx_tpu_torch.parallel import dryrun
from autovfx_tpu_torch.parallel import sharding as S
from autovfx_tpu_torch.parallel.mesh import make_mesh
from autovfx_tpu_torch.ops.rasterize import RasterConfig
from autovfx_tpu_torch.train import checkpoint as CK
from autovfx_tpu_torch.train import trainer as T


def gaussian_arrays(g) -> dict:
    return {f: getattr(g, f).detach().cpu().numpy()
            for f in convert.GAUSSIAN_FIELDS}


def _state_arrays(state) -> dict:
    out = {"g_" + k: v for k, v in gaussian_arrays(state.gaussians).items()}
    out.update({"m_" + k: v for k, v in gaussian_arrays(state.adam.m).items()})
    out.update({"v_" + k: v for k, v in gaussian_arrays(state.adam.v).items()})
    for f in ("grad_accum", "denom", "max_radii"):
        out["stats_" + f] = getattr(state.stats, f).numpy()
    return out


def _render(out) -> dict:
    color, depth, alpha = out
    return {"color": color.numpy(), "depth": depth.numpy(),
            "alpha": alpha.numpy()}


def run_cases(rank: int, world: int, inp: dict) -> dict:
    cpu = "cpu"
    config = RasterConfig(dup_budget=inp["budget"])
    out = {}

    # meshes
    mesh = make_mesh(backend="gloo", device=cpu)
    out["mesh_default"] = (mesh.shape, mesh.coords)
    if world == 4:
        m2 = make_mesh((2, 2), backend="gloo", device=cpu)
        out["mesh_2d"] = (m2.shape, m2.coords, m2.group_ranks)

    # one DP step: rank r renders camera r
    cams = convert.camera(inp["cams"], device=cpu)
    images = torch.from_numpy(inp["images"])
    cfg = T.TrainConfig(raster=config)
    mesh_dp = make_mesh((world, 1), backend="gloo", device=cpu)
    start = convert.gaussians(inp["train_g"], device=cpu)
    state, aux = S.dp_train_step(T.init_state(start), index_camera(cams, rank),
                                 images[rank], cfg, mesh_dp)
    out["dp"] = {"loss": float(aux.loss), "psnr": float(aux.psnr),
                 "overflow": bool(aux.overflow), **_state_arrays(state)}

    # the DP loop with densify and a checkpoint
    tcfg = T.TrainConfig(raster=config, **inp["loop_cfg"])
    loop, hist = S.dp_train(
        convert.gaussians(inp["loop_g"], device=cpu), cams, images, tcfg,
        mesh_dp, inp["cam_order"], torch.Generator().manual_seed(0),
        log_every=1, checkpoint_path=inp["ckpt"], checkpoint_every=6)
    out["loop"] = {"history": hist, **_state_arrays(loop)}

    # depth slabs over (1, D)
    mesh_g = make_mesh((1, world), backend="gloo", device=cpu)
    g = convert.gaussians(inp["scene"], device=cpu)
    cam = convert.camera(inp["cam"], device=cpu)
    bg = torch.from_numpy(inp["bg"])
    full = S.shard_gaussians(g, cam, world, rank)
    out["full_slab"] = gaussian_arrays(full)
    out["full"] = _render(S.sharded_render(full, cam, mesh_g, config, bg))
    compact, ovf = S.shard_gaussians_compact(g, cam, world, rank,
                                             slack=inp["slack"])
    out["compact_slab"] = gaussian_arrays(compact)
    out["compact_overflow"] = bool(ovf)
    out["compact"] = _render(S.sharded_render_compact(compact, cam, mesh_g,
                                                      config, bg))
    # the composites of JAX's own slabs
    jfull = convert.slabs(inp["jax_full_slabs"], rank, device=cpu)
    out["full_of_jax"] = _render(S.sharded_render(jfull, cam, mesh_g, config,
                                                  bg))
    jcomp = convert.slabs(inp["jax_compact_slabs"], rank, device=cpu)
    out["compact_of_jax"] = _render(S.sharded_render_compact(
        jcomp, cam, mesh_g, config, bg))
    # the distributed build from the striped store
    store = S.round_robin_store(g, world, rank)
    out["store"] = gaussian_arrays(store)
    built, ovf = S.distributed_shard_compact(store, cam, mesh_g,
                                             slack=inp["dist_slack"])
    out["dist_slab"] = gaussian_arrays(built)
    out["dist_overflow"] = bool(ovf)
    out["dist"] = _render(S.sharded_render_compact(built, cam, mesh_g, config,
                                                   bg))
    # the overflow flags on a depth-clustered scene
    flat = dataclasses.replace(g, xyz=torch.zeros_like(g.xyz))
    out["flat_overflow"] = bool(S.shard_gaussians_compact(
        flat, cam, world, rank, slack=0.0)[1])
    out["flat_pair_overflow"] = bool(S.distributed_shard_compact(
        S.round_robin_store(flat, world, rank), cam, mesh_g,
        slack=inp["dist_slack"])[1])
    # a trajectory: a gentle orbit, then a jump
    traj = convert.camera(inp["traj"], device=cpu)
    frames, reshards = S.sharded_render_trajectory(
        store, traj, inp["traj_frames"], mesh_g, config,
        slack=inp["dist_slack"])
    out["traj"] = {"frames": frames.numpy(), "reshards": reshards}

    # the dry run's body in this world
    out["dryrun"] = dryrun._dryrun_rank(rank, world, "gloo", cpu)
    if rank == 0:  # the first rank writes the checkpoint
        out["ckpt_step"] = int(CK.load_checkpoint(inp["ckpt"],
                                                  device=cpu).step)
    return out


def fail_on_rank_1(rank: int, world: int) -> int:
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank
