"""Novel views: ``ops/rasterize.rasterize`` round the configuration's ring,
black background, the duplicate budget of the ring's worst view × slack.

Frames in a closed loop: the viewer waits for each frame.  The check
compares a sample of the window's frames, drawn from the seed, with the
plain reference's render of the same view.
"""
from __future__ import annotations

import torch

from benchmark import port, scene
from benchmark.harness import Finish
from benchmark.reference import raster


class Session:
    kind = "frames"

    def __init__(self, ctx):
        from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize

        cfg, dev = ctx.config, ctx.device
        self.cfg, self.traffic, self.dev = cfg, ctx.traffic, dev
        self.tile = int(cfg["tile"])
        self.scene = scene.garden(cfg, ctx.seed, dev)
        self.views = scene.ring(cfg)
        self.period = len(self.views)
        self.g = port.gaussians(self.scene)
        self.cams = [port.camera(v, dev) for v in self.views]
        self.budget = port.budget([[self.g]] * self.period, self.cams,
                                  self.tile, cfg["budget_slack"])
        self.rcfg = RasterConfig(dup_budget=self.budget, tile=self.tile)
        self.bg = torch.zeros(3, device=dev)
        self.rasterize = rasterize
        self.sample = port.Reservoir(ctx.traffic["check_frames"], ctx.seed)
        self.overflow = []
        with torch.no_grad():  # one warm pass of the ring
            for i in range(self.period):
                self.call(i)

    def call(self, i: int):
        with torch.no_grad():
            return self.rasterize(self.g, self.cams[i % self.period],
                                  bg=self.bg, config=self.rcfg)

    def seen(self, i: int, out) -> None:
        self.overflow.append(out.overflow)
        self.sample.add(i, (i % self.period, out.color))

    def release(self) -> None:
        del self.g, self.cams

    def finish(self, trace: bool) -> Finish:
        failed = int(torch.stack(self.overflow).sum())
        sampled = self.sample.items
        todo = range(self.period) if trace else sorted({i for i, _ in sampled})
        cams = port.ref_cams(self.views, self.dev)
        ref, counts = {}, []
        for v in todo:
            out = raster.render([self.scene], cams[v], self.tile,
                                counts=trace, bg=torch.zeros(3, device=self.dev))
            img, c = out if trace else (out, None)
            if v in {i for i, _ in sampled}:
                ref[v] = img.color
            if c is not None:
                counts.append(c)
        self.ref = ref
        checks = [port.frame_check(sampled, ref,
                                   self.traffic["limits"]["frame_rmse"])]
        n, k_rest = self.scene["sh_rest"].shape[:2]
        return Finish(checks, failed, port.frame_work(
            n, k_rest, counts, self.budget) if trace else {})


    def control(self) -> list:
        """The check with the reference in bfloat16 in the program's place
        (on the frames ``finish`` compared)."""
        cams = port.ref_cams(self.views, self.dev)
        low = [(v, raster.render([self.scene], cams[v], self.tile, lowp=True,
                                 bg=torch.zeros(3, device=self.dev)).color)
               for v in self.ref]
        return [port.frame_check(low, self.ref,
                                 self.traffic["limits"]["frame_rmse"])]


def setup(ctx) -> Session:
    return Session(ctx)
