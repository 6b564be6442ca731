"""The import guard: the harness, its entries and the program load
neither JAX nor the JAX package, compared by whole top-level names, and
the benchmark's sources read nothing of the JAX package's benchmark."""
from __future__ import annotations

import subprocess
import sys
import types

from benchmark import harness

CHECK = """
import sys
sys.path.insert(0, {root!r})
from benchmark import harness
for name in harness.cell_names():
    cell = harness.resolve(name)
import autovfx_tpu_torch.render.clip, autovfx_tpu_torch.train.trainer
import autovfx_tpu_torch.ops.rasterize
print(harness.forbidden_modules())
"""


def test_nothing_forbidden_is_loaded():
    out = subprocess.run([sys.executable, "-c",
                          CHECK.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "autovfx_tpu_torch_fake",
                        types.ModuleType("autovfx_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxlib_like.sub",
                        types.ModuleType("jaxlib_like.sub"))
    before = harness.forbidden_modules()
    assert "autovfx_tpu" not in before
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.np"))
    monkeypatch.setitem(sys.modules, "autovfx_tpu.ops",
                        types.ModuleType("autovfx_tpu.ops"))
    assert set(harness.forbidden_modules()) >= {"jax", "autovfx_tpu"}


def test_sources_read_nothing_of_the_jax_benchmark():
    for path in harness.HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in ("bench.py", "BENCH_", "autovfx_tpu/", "import jax",
                     "from jax", "from autovfx_tpu ", "import autovfx_tpu\n",
                     "autovfx_tpu.", "autovfx_tpu_torch.bench"):
            assert word not in text, f"{path.name} names {word!r}"
