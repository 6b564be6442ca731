"""A new cell is data: in a copy of the benchmark, a configuration file,
a traffic file, a metric file and a ``BENCHMARK.json`` entry are added,
no file there is edited, and the harness lists and resolves the cell."""
from __future__ import annotations

import hashlib
import json
import shutil

from benchmark import harness


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_takes_only_new_files(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs/garden-1m.json").read_text())
    cfg["splats"] = 2_000_000
    (b / "configs/garden-2m.json").write_text(json.dumps(cfg))
    view = json.loads((b / "traffic/view-ring.json").read_text())
    (b / "traffic/view-close.json").write_text(json.dumps(
        dict(view, check_frames=3)))
    (b / "metrics/sort_ms.frames.py").write_text(
        "def read(r):\n    return None\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "garden-2m", "source": "https://example.org",
                         "file": "benchmark/configs/garden-2m.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "view-close-2m", "config": "garden-2m",
                           "traffic": "view-close", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "sort_ms.frames", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "binning", "moves": "frames_per_s",
                           "workloads": ["view-close-2m"]})
    fps = next(x for x in m["end_to_end"] if x["name"] == "frames_per_s")
    fps["workloads"].append("view-close-2m")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    after = digest(b)
    assert {k: v for k, v in after.items() if k in before} == before
    assert "view-close-2m" in harness.cell_names(tmp_path)
    cell = harness.resolve("view-close-2m", tmp_path)
    assert cell.config["splats"] == 2_000_000
    assert cell.traffic["check_frames"] == 3
    assert cell.entry.__file__.startswith(str(tmp_path))
    assert "sort_ms.frames" in cell.readers
    assert cell.readers["sort_ms.frames"](None) is None
    assert "frames_per_s" in {x["name"] for x in cell.end_to_end}
