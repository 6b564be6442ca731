"""3DGS training from scratch on synthetic multi-view ground truth, at
the Garden operating point: the convergence curve's run.

Counterpart of the JAX package's ``scripts/train_at_scale.py:30-129``,
with its flags plus ``--device``: it renders ground-truth views of a
seeded garden-like scene (``make_garden_like(extent=2.67)``) from a
ring of cameras, trains a FRESH model, initialized from the scene's
points with seeded noise (``RandomState(0)``), against them for
``--iters`` steps with the reference's cadence (7k of train_3dgs.sh's
15k), and prints one JSON line: iterations per second, the wall time,
the final mean PSNR over the training views, the active splats and the
last three logged points of the curve.

    python -m autovfx_tpu_torch.train_at_scale --splats 300000 \\
        --iters 7000 --width 1296 --height 840 --views 24

A small run on the CPU: ``--splats 2000 --iters 50 --width 64 --height
48 --views 4 --device cpu``.  On the card the training is timed with
CUDA events.  The scene is this package's ``make_garden_like``, whose
numpy draws differ from the JAX package's: the two scripts train the
same kind of scene, not the same one.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.core.sh import C0
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.train import trainer as T
from autovfx_tpu_torch.utils.synthetic import make_garden_like

EXTENT = 2.67


def get_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splats", type=int, default=300_000)
    ap.add_argument("--iters", type=int, default=7_000)
    ap.add_argument("--width", type=int, default=1296)
    ap.add_argument("--height", type=int, default=840)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--device", type=str, default=devices.DEFAULT,
                    help="torch device the scene trains on (cpu: the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def ring(views: int, width: int, height: int, device) -> C.Camera:
    """The ring of ``views`` cameras around the scene (radius 3.2 m,
    heights 1.2 ± 0.4 m, looking at (0, 0, 0.2))."""
    return C.stack_cameras([
        C.look_at_camera(
            [3.2 * np.cos(a), 3.2 * np.sin(a), 1.2 + 0.4 * np.sin(3 * a)],
            [0, 0, 0.2], [0, 0, 1], fx=0.74 * width, fy=0.74 * width,
            width=width, height=height, device=device)
        for a in np.linspace(0, 2 * np.pi, views, endpoint=False)])


def raster_config(splats: int) -> RasterConfig:
    return RasterConfig(dup_budget=1 << (21 if splats > 100_000 else 15))


def ground_truth(gt_model: Gaussians, cams: C.Camera,
                 cfg: RasterConfig) -> torch.Tensor:
    """(V, H, W, 3) renders of ``gt_model`` through each camera."""
    with torch.no_grad():
        return torch.stack([rasterize(gt_model, C.index_camera(cams, i),
                                      config=cfg).color
                            for i in range(C.num_cameras(cams))])


def initial_gaussians(gt_model: Gaussians) -> Gaussians:
    """The fresh model: the scene's active points and colours with seeded
    noise (``RandomState(0)``: 0.02 m on the points, 0.1 on the
    colours), opacity 0.1, in 1.5× their count of slots (the COLMAP
    points' initialization)."""
    rng = np.random.RandomState(0)
    act = gt_model.active.cpu().numpy()
    pts = gt_model.xyz.cpu().numpy()[act]
    pts = pts + 0.02 * rng.randn(*pts.shape).astype(np.float32)
    cols = np.clip(
        (gt_model.sh_dc.cpu().numpy()[act] * C0 + 0.5)
        + 0.1 * rng.randn(len(pts), 3).astype(np.float32), 0.0, 1.0)
    dev = gt_model.xyz.device
    return Gaussians.create(
        torch.from_numpy(pts).to(dev),
        torch.from_numpy(cols.astype(np.float32)).to(dev),
    ).pad_to(int(len(pts) * 1.5))


def mean_psnr(g: Gaussians, cams: C.Camera, gt: torch.Tensor,
              cfg: RasterConfig) -> float:
    """Mean over the views of each view's PSNR against ``gt``."""
    psnrs = []
    with torch.no_grad():
        for i in range(C.num_cameras(cams)):
            img = rasterize(g, C.index_camera(cams, i), config=cfg).color
            mse = float(torch.mean((img - gt[i]) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
    return float(np.mean(psnrs))


def timed_train(g0, cams, gt, cfg_t):
    """``trainer.train`` and its wall seconds: CUDA events on the card,
    the host clock on the CPU (where the work is synchronous)."""
    dev = g0.xyz.device
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    state, hist = T.train(g0, cams, gt, cfg_t,
                          log_every=max(cfg_t.iterations // 10, 1))
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        return state, hist, start.elapsed_time(end) / 1e3
    return state, hist, time.perf_counter() - t0


def main(argv: Optional[list] = None) -> dict:
    args = get_args(argv)
    device = devices.resolve(args.device)
    gt_model = make_garden_like(args.splats, extent=EXTENT, device=device)
    cams = ring(args.views, args.width, args.height, device)
    cfg_r = raster_config(args.splats)
    gt = ground_truth(gt_model, cams, cfg_r)
    g0 = initial_gaussians(gt_model)
    cfg_t = T.TrainConfig(raster=cfg_r, iterations=args.iters,
                          densify_until_iter=min(args.iters // 2, 15_000))
    state, hist, wall = timed_train(g0, cams, gt, cfg_t)
    final = state.gaussians
    result = {
        "metric": (f"3DGS from-scratch training {args.width}x{args.height}"
                   f" ({args.splats} GT splats, {args.views} views,"
                   f" {args.iters} iters)"),
        "value": round(args.iters / wall, 2),
        "unit": "iters/s",
        "wall_seconds": round(wall, 1),
        "final_psnr": round(mean_psnr(final, cams, gt, cfg_r), 2),
        "active_splats": int(final.num_active),
        "history": hist[-3:],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
