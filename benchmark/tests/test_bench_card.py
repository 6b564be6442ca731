"""A cell run as its command runs it, on the card: one short plain run and
one traced run of each cell, correct, with every metric the cell
reports.  Skipped without a CUDA card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", harness.cell_names())
def test_cell_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 101), "--seconds", "2", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    cell = harness.resolve(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {x["name"] for x in want}
    assert r["device"]["platform"] == "gpu"
