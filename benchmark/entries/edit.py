"""Edited frames: ``render/clip.render_edited_frame_fused`` round the ring,
one frame a camera: the background and the IBL-shaded cube in one merged
render, the hull object weight, the hull shadow and the composite.

The benchmark makes the cube's surfels, hull planes and seeded drop with
a bounce (the physics solve is outside the cell), and the seeded
envmap; the program builds its clip inputs from them
(``build_clip_inputs``: lights, envmap SH, hull trim), and the reference
works all of that out again.  The budget is the merged render's worst
view × slack.  Frames in a closed loop; the check compares a sample of
the window's frames, drawn from the seed, with the reference's frame.  A
frame whose merged render needs more duplicates than the budget (by the
reference's count) is a failed call.
"""
from __future__ import annotations

import functools
import types

import torch

from benchmark import port, scene
from benchmark.harness import Finish
from benchmark.reference import edit as ref_edit
from benchmark.reference import raster


class Session:
    kind = "frames"

    def __init__(self, ctx):
        from autovfx_tpu_torch.core.cameras import stack_cameras
        from autovfx_tpu_torch.ops.rasterize import RasterConfig
        from autovfx_tpu_torch.render import clip

        cfg, dev, seed = ctx.config, ctx.device, ctx.seed
        e = cfg["edit"]
        self.cfg, self.traffic, self.dev = cfg, ctx.traffic, dev
        self.tile = int(cfg["tile"])
        self.scene = scene.garden(cfg, seed, dev)
        self.views = scene.ring(cfg)
        self.period = len(self.views)
        self.surf = scene.cube_surfels(e, seed, dev)
        self.planes, self.mask = scene.cube_hull(e)
        self.pos, self.rot = scene.cube_drop(e, self.period, seed)
        self.env = scene.envmap(e, seed)
        g = port.gaussians(self.scene)
        cams = [port.camera(v, dev) for v in self.views]
        self.inp = clip.build_clip_inputs(
            bg=g, cams=stack_cameras(cams),
            objects=[{"scale": 1.0, "material": dict(e["material"])}],
            surfels=[self.surf], traj_pos=self.pos, traj_rot=self.rot,
            hull_shape=types.SimpleNamespace(planes=self.planes,
                                             plane_mask=self.mask),
            env=self.env, num_lights=e["lights"], device=dev)
        with torch.no_grad():
            sets = [[g, clip.shaded_object_gaussians(self.inp, i, c)]
                    for i, c in enumerate(cams)]
        self.budget = port.budget(sets, cams, self.tile, cfg["budget_slack"])
        self.n_splats = sum(s.capacity for s in sets[0])
        del sets
        self.frame = functools.partial(
            clip.render_edited_frame_fused,
            config=RasterConfig(dup_budget=self.budget, tile=self.tile),
            shadow_scale=e["shadow_scale"])
        self.sample = port.Reservoir(ctx.traffic["check_frames"], seed)
        self.index = []
        for i in range(self.period):  # one warm pass of the clip
            self.call(i)

    def call(self, i: int):
        with torch.no_grad():
            return self.frame(self.inp, i % self.period)

    def seen(self, i: int, out) -> None:
        self.index.append(i % self.period)
        self.sample.add(i, (i % self.period, out))

    def release(self) -> None:
        del self.inp, self.frame

    def finish(self, trace: bool) -> Finish:
        e = self.cfg["edit"]
        cams = port.ref_cams(self.views, self.dev)
        clip = ref_edit.make_clip(self.surf, e["material"], self.pos,
                                  self.rot, self.planes, self.mask, self.env,
                                  e["lights"], self.dev)
        with torch.no_grad():
            over = {i for i, cam in enumerate(cams) if raster.need(
                [self.scene, *ref_edit.objects(clip, i, cam)], cam,
                self.tile) > self.budget}
        failed = sum(i in over for i in self.index)
        sampled = self.sample.items
        picked = {i for i, _ in sampled}
        todo = range(self.period) if trace else sorted(picked)
        ref, counts = {}, []
        with torch.no_grad():
            for i in todo:
                out = ref_edit.frame(self.scene, clip, i, cams[i], self.tile,
                                     e["shadow_scale"], counts=trace)
                img, c = out if trace else (out, None)
                if i in picked:
                    ref[i] = img
                if c is not None:
                    counts.append(c)
        self.ref, self.clip = ref, clip
        checks = [port.frame_check(sampled, ref,
                                   self.traffic["limits"]["frame_rmse"])]
        if not trace:
            return Finish(checks, failed, {})
        return Finish(checks, failed, port.frame_work(
            self.n_splats, self.scene["sh_rest"].shape[1], counts,
            self.budget))


    def control(self) -> list:
        """The check with the reference in bfloat16 in the program's place
        (on the frames ``finish`` compared)."""
        cams = port.ref_cams(self.views, self.dev)
        e = self.cfg["edit"]
        with torch.no_grad():
            low = [(i, ref_edit.frame(self.scene, self.clip, i, cams[i],
                                      self.tile, e["shadow_scale"],
                                      lowp=True)) for i in self.ref]
        return [port.frame_check(low, self.ref,
                                 self.traffic["limits"]["frame_rmse"])]


def setup(ctx) -> Session:
    return Session(ctx)
