"""Coarse SuGaR: ``sugar/coarse_train.coarse_step`` with the density
regularizer on from the first step, round the ring, steps back to back:
two renders, the opacity entropy, the density target and the normal
consistency on the configuration's SDF samples a step, each with its
16-neighbour list (rebuilt every step by the program), then Adam.

Set-up starts from the seeded perturbation of the scene
(``benchmark/steps.py``), does the opacity prune at regularization
start, which records how many splats stay, and the neighbour reset.
The check steps draw their samples from the benchmark's seed (both
sides take the same draws); the window's steps draw from the program's
own generator, seeded from the seed.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from benchmark import scene, steps
from benchmark.reference import sugar as ref_sugar


class Session(steps.StepSession):
    def prepare(self) -> None:
        from autovfx_tpu_torch.sugar import coarse_train, density

        s = self.cfg["sugar"]
        g = self.state.gaussians
        keep = torch.sigmoid(self.start["opacity_logit"]) >= s["prune_opacity"]
        self.start = dict(self.start, active=self.start["active"] & keep)
        self.state = dataclasses.replace(self.state, gaussians=(
            dataclasses.replace(g, active=self.start["active"])))
        self.live = int(self.start["active"].sum())
        print(f"sugar: {self.live} of {g.capacity} splats stay after the "
              f"opacity prune at {s['prune_opacity']}", file=sys.stderr)
        density.reset_neighbors(self.state.gaussians, k=s["neighbors"])
        self.scfg = coarse_train.SugarConfig(
            base=self.tcfg, entropy_weight=s["entropy_weight"],
            sdf_weight=s["sdf_weight"], normal_weight=s["normal_weight"],
            sdf_mode="density", regularize_from=0,
            n_sdf_samples=s["sdf_samples"])
        self.gen = scene.generator(self.seed + 4, self.dev)
        self.draws = [self.draw(k) for k in
                      range(self.traffic["check_steps"])]
        self.coarse_step = coarse_train.coarse_step

    def draw(self, k: int) -> tuple:
        """Step ``k``'s samples: source splats uniform over the live ones,
        standard normal offsets."""
        gen = scene.generator(self.seed + 5 + k, self.dev)
        live = torch.nonzero(self.start["active"])[:, 0]
        n = self.cfg["sugar"]["sdf_samples"]
        pick = torch.randint(0, live.shape[0], (n,), generator=gen,
                             device=self.dev)
        return live[pick], torch.randn((n, 3), generator=gen, device=self.dev)

    def program_step(self, k: int, check: bool):
        v = k % self.period
        self.state, aux = self.coarse_step(
            self.state, self.cams[v], self.targets[v], self.scfg, True,
            self.gen, self.draws[k] if check else None)
        return aux

    def release(self) -> None:
        super().release()
        del self.gen

    def reference(self, n: int, lowp: bool) -> dict:
        cams, targets = self.ref_targets(n, lowp)
        return ref_sugar.run(self.start, cams, targets, self.draws[:n],
                             self.tile, dict(self.cfg["train"]),
                             self.cfg["sugar"], lowp)

    def work(self) -> dict:
        """The training step's counted work twice over (the program renders
        and differentiates twice a step), and the density field and its
        gradient over the samples × neighbours, forward and backward: the
        samples, their neighbour lists and each splat's center, inverse
        covariance and opacity read once a pass, the splats' gradients
        written once; 120 float32 operations and 2 exps a (sample,
        neighbour) pair."""
        w = super().work()
        for k in ("preprocess", "duplicate", "blend_fwd", "blend_bwd",
                  "preprocess_bwd"):
            w[k] = tuple(2 * x for x in w[k])
        s = self.cfg["sugar"]
        n = self.start["xyz"].shape[0]
        samples, pairs = s["sdf_samples"], s["sdf_samples"] * s["neighbors"]
        w["density"] = (2 * samples * (3 * 4 + 8 * s["neighbors"] + 4)
                        + 3 * n * 4 * (3 + 9 + 1), 120.0 * pairs, 2.0 * pairs)
        return w


def setup(ctx) -> Session:
    return Session(ctx)
