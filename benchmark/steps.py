"""What the training entries share: set-up of one training state from the
seeded scene, its check steps through the window's own call, and the
check of the steps against the reference's.

Set-up renders the targets (the program's renders of the seeded scene
round the ring), makes the start (a seeded perturbation of the scene:
the SH DC colors moved by ``dc_noise`` normal noise, the opacity logits
by ``logit_shift``), builds one training state and drives it through
the traffic's ``check_steps`` first steps, step k on view k; the same
state then runs the window.  The reference follows those steps from the
same start, with targets it renders itself.  The check compares each
step's loss, the first step's gradients (Adam's first moment over
1 - b1) and the parameters' change after the check steps, each leaf by
the gap of its norm over the larger of the reference leaf's norm and
the median leaf's; leaves whose reference gradient is under a thousandth
of the median leaf's are left out of the change.  The change compared is
the worst leaf's, or with the traffic's ``"change_leaf": "median"`` the
median leaf's: where rounding-level gradients are common (SuGaR's
density terms cancel exactly in one summation order and to ~1e-10 in
another), Adam's first step turns each into a full step of either sign,
and the worst leaf's change then reads the accumulation order.
"""
from __future__ import annotations

import torch

from benchmark import port, scene, work
from benchmark.harness import Check, Finish
from benchmark.reference import raster
from benchmark.reference import train as ref_train

ADAM_B1 = 0.9
FIELDS = ref_train.FIELDS
TRAIN_KEYS = ("position_lr_init", "position_lr_final", "position_lr_max_steps",
              "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr",
              "spatial_lr_scale", "lambda_dssim")


def perturbed(target: dict, traffic: dict, seed: int) -> dict:
    gen = scene.generator(seed + 3, target["xyz"].device)
    noise = torch.randn(target["sh_dc"].shape, generator=gen,
                        device=target["xyz"].device)
    start = dict(target)
    start["sh_dc"] = target["sh_dc"] + traffic["dc_noise"] * noise
    start["opacity_logit"] = target["opacity_logit"] + traffic["logit_shift"]
    return start


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    norms = {f: float(torch.linalg.norm(ref[f].double())) for f in ref}
    med = sorted(norms.values())[len(norms) // 2]
    return [abs(float(torch.linalg.norm(prog[f].double())) - norms[f])
            / max(norms[f], med, 1e-30)
            for f in ref if keep is None or f in keep]


class StepSession:
    """A training entry's session; subclasses give ``prepare`` (the state
    before the check steps), ``program_step`` and ``reference``."""

    kind = "steps"

    def __init__(self, ctx):
        from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
        from autovfx_tpu_torch.train import trainer

        cfg, dev, seed = ctx.config, ctx.device, ctx.seed
        self.cfg, self.traffic, self.dev, self.seed = (cfg, ctx.traffic, dev,
                                                       seed)
        self.tile = int(cfg["tile"])
        self.target = scene.garden(cfg, seed, dev)
        self.views = scene.ring(cfg)
        self.period = len(self.views)
        self.cams = [port.camera(v, dev) for v in self.views]
        g = port.gaussians(self.target)
        self.budget = port.budget([[g]] * self.period, self.cams, self.tile,
                                  cfg["budget_slack"])
        self.rcfg = RasterConfig(dup_budget=self.budget, tile=self.tile)
        bg = torch.zeros(3, device=dev)
        with torch.no_grad():
            self.targets = [rasterize(g, c, bg=bg, config=self.rcfg).color
                            for c in self.cams]
        self.start = perturbed(self.target, ctx.traffic, seed)
        self.tcfg = trainer.TrainConfig(
            raster=self.rcfg, **{k: cfg["train"][k] for k in TRAIN_KEYS})
        self.state = trainer.init_state(port.gaussians(self.start))
        self.prepare()
        self.overflow, self.losses = [], []
        self.first = n = ctx.traffic["check_steps"]
        for k in range(n):  # the check steps: the window's own call
            aux = self.program_step(k, check=True)
            self.losses.append(aux.loss)
            if k == 0:
                self.grads = {f: getattr(self.state.adam.m, f) / (1 - ADAM_B1)
                              for f in FIELDS}
        g_now = self.state.gaussians
        self.change = {f: getattr(g_now, f) - self.start[f] for f in FIELDS}

    def prepare(self) -> None:
        pass

    def call(self, i: int):
        return self.program_step(self.first + i, check=False)

    def seen(self, i: int, out) -> None:
        self.overflow.append(out.overflow)

    def release(self) -> None:
        self.losses = [float(x) for x in self.losses]
        del self.state, self.targets, self.cams

    def finish(self, trace: bool) -> Finish:
        failed = int(torch.stack(self.overflow).sum())
        self.ref = self.reference(len(self.losses), lowp=False)
        checks = self.compare(self.losses, self.grads, self.change)
        return Finish(checks, failed, self.work() if trace else {})

    def ref_targets(self, n: int, lowp: bool) -> tuple[list, list]:
        """The reference's first ``n`` cameras and its renders of the scene
        through them."""
        cams = port.ref_cams(self.views, self.dev)[:n]
        bg = torch.zeros(3, device=self.dev)
        return cams, [raster.render([self.target], c, self.tile, lowp=lowp,
                                    bg=bg).color for c in cams]

    def compare(self, losses: list, grads: dict, change: dict) -> list:
        ref = self.ref
        loss_gap = max(abs(p - r) / abs(r)
                       for p, r in zip(losses, ref["losses"]))
        g_norm = {f: float(torch.linalg.norm(ref["grads"][f].double()))
                  for f in FIELDS}
        med = sorted(g_norm.values())[len(g_norm) // 2]
        moved = {f for f in FIELDS if g_norm[f] >= 1e-3 * med}
        lim = self.traffic["limits"]
        change_gaps = sorted(leaf_gaps(change, ref["change"], moved))
        over = self.traffic.get("change_leaf", "worst")
        change_gap = (change_gaps[-1] if over == "worst"
                      else change_gaps[len(change_gaps) // 2])
        return [Check("loss_gap", loss_gap, lim["loss_gap"]),
                Check("grad_gap", max(leaf_gaps(grads, ref["grads"])),
                      lim["grad_gap"]),
                Check("change_gap", change_gap, lim["change_gap"])]

    def control(self) -> list:
        """The check with the reference in bfloat16 in the program's place."""
        low = self.reference(len(self.losses), lowp=True)
        return self.compare(low["losses"], low["grads"], low["change"])

    def counts(self, fields: dict) -> list:
        """The plain blend's counts of ``fields`` round the ring."""
        with torch.no_grad():
            return [raster.render([fields], c, self.tile, counts=True)[1]
                    for c in port.ref_cams(self.views, self.dev)]

    def work(self) -> dict:
        """Kernels 1-4, the preprocess backward and Adam of one step,
        counted on the start's views (the state moves little from it)."""
        counts = self.counts(self.start)
        n, k_rest = self.start["sh_rest"].shape[:2]
        w = port.frame_work(n, k_rest, counts, self.budget)
        w["blend_fwd"] = port.mean_work([work.blend(c, train=True)
                                         for c in counts])
        w["blend_bwd"] = port.mean_work([work.blend(c, backward=True)
                                         for c in counts])
        w["preprocess_bwd"] = work.preprocess_bwd(n, k_rest)
        w["adam"] = work.adam(n, k_rest)
        return w
