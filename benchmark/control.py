"""Readings for the limits of a cell's check: the program's numbers over
many seeds (the lower readings), the control's (the reference in
bfloat16 in the program's place: the upper readings), and the program's
with a fault planted (``--fault``).  Not part of a benchmark run.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] \
        [--control-seeds 3] [--seconds 1] [--fault half]

Each seed makes the cell anew in this process (the kernels build once),
runs a short window at the cell's own load, and prints one JSON line:
the seed, the program's checks and, for the first ``--control-seeds``
seeds, the control's.  ``--fault half`` takes a training step's loss
over the top half of the image only (half of the batch left out, the
mean taken over the rest).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def half_loss():
    """Plant the fault: the photometric loss over the top half only."""
    from autovfx_tpu_torch.train import losses

    real = losses.photometric_loss

    def top_half(pred, gt, lambda_dssim=0.2):
        h = pred.shape[0] // 2
        return real(pred[:h], gt[:h], lambda_dssim)

    losses.photometric_loss = top_half


FAULTS = {"half": half_loss}


def readings(cell, seed: int, seconds: float, control: bool, device,
             sync) -> dict:
    from benchmark import harness

    sess = cell.entry.setup(harness.Context(cell.config, cell.traffic, seed,
                                            device))
    harness.window(sess, seconds, sync)
    sess.release()
    fin = sess.finish(False)
    out = {"seed": seed, "failed": fin.failed,
           "program": {c.name: c.value for c in fin.checks}}
    if control:
        out["control"] = {c.name: c.value for c in sess.control()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    from benchmark import harness

    harness.use_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.fault:
        FAULTS[args.fault]()
    cell = harness.resolve(args.workload)
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = readings(cell, seed, args.seconds,
                     not args.fault and k < args.control_seeds, dev,
                     lambda: torch.cuda.synchronize(dev))
        r["fault"] = args.fault
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
