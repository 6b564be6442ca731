"""What the entries share: the program's objects made from the benchmark's
inputs, the duplicate budget as the program sizes it, and the frames'
sampled check.

The program is ``autovfx_tpu_torch``; it is imported inside the
functions, so that the harness's own modules load without it.
"""
from __future__ import annotations

import random

import torch

from benchmark import scene, work
from benchmark.harness import Check
from benchmark.reference import raster


def gaussians(fields: dict):
    """The program's ``Gaussians`` over the benchmark's tensors (no copy)."""
    from autovfx_tpu_torch.core.gaussians import Gaussians

    return Gaussians(**{f: fields[f] for f in (*scene.FIELDS, "active")})


def camera(view: scene.View, device):
    """The program's ``Camera`` of a benchmark view (the same numbers)."""
    from autovfx_tpu_torch.core.cameras import Camera

    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return Camera(R=f(view.R), t=f(view.t), fx=f(view.fx), fy=f(view.fy),
                  cx=f(view.cx), cy=f(view.cy), width=view.width,
                  height=view.height)


def budget(sets_of_view: list, cams: list, tile: int, slack: float) -> int:
    """The ring's worst ``binning.required_budget`` over each view's sets,
    rounded up with ``slack``: the duplicate budget as the program's own
    bench sizes it."""
    from autovfx_tpu_torch.ops import binning
    from autovfx_tpu_torch.ops.rasterize import RasterConfig, preprocess_sets

    cfg = RasterConfig(tile=tile)
    with torch.no_grad():
        worst = max(int(binning.required_budget(
            preprocess_sets(sets, cam, cfg)))
            for sets, cam in zip(sets_of_view, cams))
    return binning.round_budget(worst, slack=slack)


class Reservoir:
    """A uniform sample of ``k`` of the window's calls, drawn from the seed
    as the calls come (reservoir sampling): (call, frame index, output)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def add(self, i: int, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.items[j] = item


def rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a.float() - b.float()) ** 2)))


def frame_check(sampled: list, reference: dict, limit: float) -> Check:
    """The worst RMS gap between a sampled frame and the reference's frame
    of the same index."""
    worst = max(rmse(out, reference[idx]) for idx, out in sampled)
    return Check("frame_rmse", worst, limit)


def ref_cams(views: list, device) -> list:
    return [raster.cam_of(v, device) for v in views]


def mean_work(ws: list) -> tuple:
    return tuple(sum(x) / len(ws) for x in zip(*ws))


def frame_work(n: int, k_rest: int, counts: list, budget: int) -> dict:
    """Kernels 1-3 of one frame over ``n`` slots, averaged over the views
    whose plain-blend ``counts`` are given."""
    return {"preprocess": work.preprocess(n, k_rest),
            "duplicate": mean_work([work.duplicate(n, c.live, budget)
                                    for c in counts]),
            "blend_fwd": mean_work([work.blend(c) for c in counts])}
