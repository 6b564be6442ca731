"""``BENCHMARK.json``'s names, units and references, and that every cell
resolves to its files."""
from __future__ import annotations

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = harness.manifest()


def test_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for w in M["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200


def test_metrics_units_and_moves():
    e2e = {x["name"] for x in M["end_to_end"]}
    assert "setup_s" in e2e
    for x in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert (harness.HERE / "metrics" / f"{x['name']}.py").exists()
    for x in M["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in M["per_layer"]:
        assert x["moves"] in e2e
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"
        moved = next(m for m in M["end_to_end"] if m["name"] == x["moves"])
        assert set(x["workloads"]) <= set(moved.get("workloads",
                                                    x["workloads"]))


@pytest.mark.parametrize("name", harness.cell_names())
def test_cell_resolves(name):
    cell = harness.resolve(name)
    assert hasattr(cell.entry, "setup")
    got = {x["name"] for x in cell.end_to_end}
    assert "setup_s" in got and len(got) >= 2 and cell.per_layer
    for x in cell.per_layer:
        assert x["moves"] in got


def test_configs_hold_their_files():
    for c in M["configs"]:
        path = harness.ROOT / c["file"]
        assert path.parent == harness.HERE / "configs"
        cfg = json.loads(path.read_text())
        assert cfg["source"] and cfg["assumed"] and not c["reduced"]
        assert c["source"].startswith("https://")
