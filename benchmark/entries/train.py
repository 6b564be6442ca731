"""3DGS training: ``train/trainer.train_step`` round the ring, no densify,
steps issued back to back (``benchmark/steps.py`` sets up the state and
checks its first steps).  Training starts from a seeded perturbation of
the target scene, so each step fits a target it can reach and its work
stays steady over the window."""
from __future__ import annotations

from benchmark import steps
from benchmark.reference import train as ref_train


class Session(steps.StepSession):
    def prepare(self) -> None:
        from autovfx_tpu_torch.train import trainer

        self.train_step = trainer.train_step

    def program_step(self, k: int, check: bool):
        v = k % self.period
        self.state, aux = self.train_step(self.state, self.cams[v],
                                          self.targets[v], self.tcfg)
        return aux

    def reference(self, n: int, lowp: bool) -> dict:
        cams, targets = self.ref_targets(n, lowp)
        return ref_train.run(self.start, cams, targets, self.tile,
                             dict(self.cfg["train"]), lowp)


def setup(ctx) -> Session:
    return Session(ctx)
