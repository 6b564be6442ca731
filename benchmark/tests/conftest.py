"""Shared pieces of the benchmark's CPU tests: a cell cut to a size a
test run holds (3,000 splats, 96×64, tile 16, 500 surfels, 4,000 SDF samples) and run
through the harness on the CPU, past its look for a card."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = {"splats": 3000, "width": 96, "height": 64, "tile": 16}
SUGAR = {"sdf_samples": 4000}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.resolve(name)
    cfg = dict(cell.config, **TINY)
    cfg["edit"] = dict(cfg["edit"], surfels=500)
    if "sugar" in cfg:
        cfg["sugar"] = dict(cfg["sugar"], **SUGAR)
    return cell._replace(config=cfg)


def run_tiny(name: str, seed: int = 2**31 + 11, trace: bool = False,
             seconds: float = 0.3) -> dict:
    torch.set_num_threads(4)
    return harness.run(tiny_cell(name), seed, seconds, trace,
                       torch.device("cpu"), time.perf_counter(),
                       log=lambda s: None)


@pytest.fixture(scope="session")
def cells() -> list[str]:
    return harness.cell_names()
