"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, last,
``checks``: each number the check compared with its limit, which the
last lines of standard error repeat.  Without a CUDA card, with fewer
cards than the cell asks for, or with ``jax``, ``jaxlib``, ``flax`` or
``autovfx_tpu`` loaded, it prints no result and exits non-zero.

Kernel caches stay inside the checkout at fixed paths: the program
builds its nvcc library under ``build/kernels/<hash>/``, and Triton,
PyTorch extensions and the inductor use ``build/triton``,
``build/torch_extensions`` and ``build/inductor``.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def get_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def clean(harness) -> bool:
    """No forbidden module is loaded; else say which on standard error."""
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
    return not bad


def main(argv=None) -> int:
    args = get_args(argv)
    from benchmark import harness

    harness.use_cache_dirs()
    cell = harness.resolve(args.workload)
    import torch

    if not clean(harness):
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    age = harness.process_age_s()
    started = time.perf_counter() - age if age is not None else STARTED
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), started)
    if not clean(harness):
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
