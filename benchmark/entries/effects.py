"""Effects frames: ``render/clip.render_edited_frame_fused`` over a clip of
a burning, melting object, one frame a camera: the background, the
IBL-shaded cube's melting surfels and the smoke splats in one merged
render, the hull object weight and shadow, and the fire splats' own
render added on top.

Set-up runs the program's own solves over the clip, as an edit does:
``render/smoke.simulate_smoke`` over the seeded inflow (adaptive, as the
configuration's domain says), and ``render/liquid.MeltSim.run`` on the
cube's surfels posed at rest.
``build_clip_inputs`` takes both; the merged budget is the clip's worst
frame (background, shaded cube and that frame's smoke set) × slack, and
the fire render keeps the program's own budget (``clip.fire_config``).
One warm pass of the clip ends set-up.  Call ``i`` renders clip frame
``i mod F`` through camera ``i mod F``, in a closed loop.

The check solves the clip again in the plain reference
(``reference/effects``) from the same configuration and seeded inputs,
and compares a sample of the window's frames, drawn from the seed, with
the reference's frame of the same index (``frame_rmse``).  In the
Garden-like layout every camera of the ring sees the clutter within
half a metre, so the cube and the smoke in the merged render never show
in a frame; only the fire, rendered alone and added, does.  So after the
window, ``release`` renders ``CLEAR`` frames spread over the clip from
the state and the frame function the window drove, with the
background's splats switched off, and the check compares them with the
reference's (``effects_rmse``).  A frame whose
merged render or fire render needs more duplicates than its budget (by
the reference's count) is a failed call.  Traced, the counted work of a
call is the mean over every sixth frame of the clip (frames 0, 6, ...):
kernel 1 over the four sets' slots, kernels 2 and 3 from the
reference's counts of the merged render and of the fire render.
"""
from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import torch

from benchmark import port, scene, work
from benchmark.harness import Finish
from benchmark.reference import edit as ref_edit
from benchmark.reference import effects as ref_fx

COUNT_EVERY = 6  # the traced check counts the work of every sixth frame
CLEAR = 4  # frames of the effects check, spread over the clip past frame 0


def _add(*works: tuple) -> tuple:
    return tuple(sum(x) for x in zip(*works))


class Session:
    kind = "frames"

    def __init__(self, ctx):
        from autovfx_tpu_torch.core.cameras import stack_cameras
        from autovfx_tpu_torch.ops.rasterize import RasterConfig
        from autovfx_tpu_torch.render import clip, liquid, smoke

        cfg, dev, seed = ctx.config, ctx.device, ctx.seed
        e, fx = cfg["edit"], cfg["effects"]
        self.cfg, self.traffic, self.dev = cfg, ctx.traffic, dev
        self.tile = int(cfg["tile"])
        self.scene = scene.garden(cfg, seed, dev)
        self.views = scene.ring(cfg)
        self.period = len(self.views)
        self.surf = scene.cube_surfels(e, seed, dev)
        self.planes, self.mask = scene.cube_hull(e)
        self.pos, self.rot = ref_fx.rest_pose(e, self.period, seed)
        self.env = scene.envmap(e, seed)
        self.place = ref_fx.placement(fx, self.pos, seed)
        self.melt_in = ref_fx.melt_inputs(self.surf, self.pos, self.rot,
                                          self.period)
        g = port.gaussians(self.scene)
        cams = [port.camera(v, dev) for v in self.views]

        s_cfg = smoke.SmokeConfig(**fx["smoke"])
        inflow = smoke.sphere_inflow(s_cfg, self.place.inflow_cell,
                                     self.place.inflow_radius, device=dev)
        adaptive = fx["domain"]["adaptive"]
        states = smoke.simulate_smoke(
            s_cfg, inflow, self.period, adaptive=adaptive,
            max_shift=fx["domain"]["max_shift"])
        states, *cells = states if adaptive else (states,)
        melt = liquid.MeltSim(
            self.melt_in.points, self.melt_in.normals, ground_z=e["ground_z"],
            cfg=liquid.LiquidConfig(**fx["melt"]),
            device=dev).run(self.melt_in.progress)
        self.inp = clip.build_clip_inputs(
            bg=g, cams=stack_cameras(cams),
            objects=[{"scale": 1.0, "material": dict(e["material"])}],
            surfels=[self.surf], traj_pos=self.pos, traj_rot=self.rot,
            hull_shape=types.SimpleNamespace(planes=self.planes,
                                             plane_mask=self.mask),
            env=self.env, num_lights=e["lights"],
            smoke_traj=(states, self.place.origin, self.place.extent, s_cfg,
                        *cells),
            melt=dict(pos=melt.tracer_pos, norm=melt.tracer_norm,
                      mask=np.ones(len(self.melt_in.points), bool)),
            device=dev)
        del states, melt
        with torch.no_grad():
            smoke_slots = clip.smoke_gaussians(self.inp, 0, s_cfg)[0].capacity
            sets = ([g, clip.shaded_object_gaussians(self.inp, i, c),
                     clip.smoke_gaussians(self.inp, i, s_cfg)[0]]
                    for i, c in enumerate(cams))
            self.budget = port.budget(sets, cams, self.tile,
                                      cfg["budget_slack"])
        # slots of the background, the cube and the smoke set (the fire's)
        self.slots = (g.capacity, len(self.melt_in.points), smoke_slots)
        config = RasterConfig(dup_budget=self.budget, tile=self.tile)
        self.fire_budget = clip.fire_config(config).dup_budget
        self.frame = functools.partial(
            clip.render_edited_frame_fused, config=config,
            shadow_scale=e["shadow_scale"], smoke_cfg=s_cfg)
        self.sample = port.Reservoir(ctx.traffic["check_frames"], seed)
        self.index = []
        for i in range(self.period):  # one warm pass of the clip
            self.call(i)

    def _bare(self) -> dict:
        """The background's fields with every splat switched off."""
        return dict(self.scene, active=torch.zeros_like(self.scene["active"]))

    def call(self, i: int):
        with torch.no_grad():
            return self.frame(self.inp, i % self.period)

    def seen(self, i: int, out) -> None:
        self.index.append(i % self.period)
        self.sample.add(i, (i % self.period, out))

    def release(self) -> None:
        # the effects check's frames, from the window's own state
        bare = dataclasses.replace(self.inp, bg=port.gaussians(self._bare()))
        with torch.no_grad():
            self.clear = [(i, self.frame(bare, i)) for i in
                          (self.period * (k + 1) // (CLEAR + 1)
                           for k in range(CLEAR))]
        del self.inp, self.frame

    def finish(self, trace: bool) -> Finish:
        e = self.cfg["edit"]
        cams = port.ref_cams(self.views, self.dev)
        self.clip = ref_edit.make_clip(
            self.surf, e["material"], self.pos, self.rot, self.planes,
            self.mask, self.env, e["lights"], self.dev)
        self.fx = ref_fx.solve(self.cfg["effects"], self.place, self.melt_in,
                               e["ground_z"], self.period, self.dev)
        over = set()
        for i in sorted(set(self.index)):
            merged, fire = ref_fx.need(self.scene, self.clip, self.fx, i,
                                       cams[i], self.tile)
            if merged > self.budget or fire > self.fire_budget:
                over.add(i)
        failed = sum(i in over for i in self.index)
        sampled = self.sample.items
        picked = {i for i, _ in sampled}
        counted = set(range(0, self.period, COUNT_EVERY)) if trace else set()
        ref, works = {}, []
        for i in sorted(picked | counted):
            out = ref_fx.frame(self.scene, self.clip, self.fx, i, cams[i],
                               self.tile, e["shadow_scale"],
                               counts=i in counted)
            img = out[0] if i in counted else out
            if i in picked:
                ref[i] = img
            if i in counted:
                works.append(self._work(*out[1:]))
        self.ref = ref
        self.ref_clear = {i: ref_fx.frame(self._bare(), self.clip, self.fx, i,
                                          cams[i], self.tile,
                                          e["shadow_scale"])
                          for i, _ in self.clear}
        checks = self._checks(sampled, ref, self.clear, self.ref_clear)
        if not trace:
            return Finish(checks, failed, {})
        return Finish(checks, failed, {k: port.mean_work([w[k] for w in works])
                                       for k in works[0]})

    def _work(self, merged, fire) -> dict:
        """Kernels 1-3 of one frame's two renders: the merged render of
        the background, cube and smoke slots, and the fire render."""
        k_rest = self.scene["sh_rest"].shape[1]
        n, flame = sum(self.slots), self.slots[-1]
        return {"preprocess": _add(work.preprocess(n, k_rest),
                                   work.preprocess(flame, k_rest)),
                "duplicate": _add(work.duplicate(n, merged.live, self.budget),
                                  work.duplicate(flame, fire.live,
                                                 self.fire_budget)),
                "blend_fwd": _add(work.blend(merged), work.blend(fire))}

    def _checks(self, sampled, ref, clear, ref_clear) -> list:
        lim = self.traffic["limits"]
        return [port.frame_check(sampled, ref, lim["frame_rmse"]),
                port.frame_check(clear, ref_clear, lim["effects_rmse"])
                ._replace(name="effects_rmse")]

    def control(self) -> list:
        """The check with the reference in bfloat16 in the program's place
        (on the frames ``finish`` compared)."""
        cams = port.ref_cams(self.views, self.dev)
        e = self.cfg["edit"]
        low = lambda bg, i: ref_fx.frame(bg, self.clip, self.fx, i, cams[i],
                                         self.tile, e["shadow_scale"],
                                         lowp=True)
        return self._checks([(i, low(self.scene, i)) for i in self.ref],
                            self.ref,
                            [(i, low(self._bare(), i)) for i in self.ref_clear],
                            self.ref_clear)


def setup(ctx) -> Session:
    return Session(ctx)
