"""Package guards of the PyTorch port.

The machine with the card has no JAX, so the port must import, render
and take a training step with JAX and the JAX package unimportable;
importing it must not need ``nvcc``; and a CPU tensor must never reach
the CUDA library loader.
"""
import os
import subprocess
import sys
import textwrap

import pytest

import autovfx_tpu_torch
from autovfx_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RENDER_500 = textwrap.dedent("""
    import torch
    import autovfx_tpu_torch as P
    from autovfx_tpu_torch.core.cameras import look_at_camera
    from autovfx_tpu_torch.utils.synthetic import make_gaussians
    import numpy as np

    g = make_gaussians(500, np.random.default_rng(0))
    cam = look_at_camera([4.0, 0.6, 0.8], [0, 0, 0], [0, 0, 1],
                         fx=57.6, fy=57.6, width=64, height=48)
    out = P.rasterize(g, cam, config=P.RasterConfig(dup_budget=1 << 14))
    assert out.color.shape == (48, 64, 3)
    assert torch.isfinite(out.color).all() and float(out.alpha.max()) > 0.1
    from autovfx_tpu_torch.train import trainer as T
    cfg = T.TrainConfig(raster=P.RasterConfig(dup_budget=1 << 14))
    state, aux = T.train_step(T.init_state(g), cam, out.color.flip(1), cfg)
    assert state.step == 1 and torch.isfinite(aux.loss)
    assert not torch.equal(state.gaussians.xyz, g.xyz)
    blocked = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "autovfx_tpu")
               and sys.modules[m] is not None]
    assert not blocked, blocked
    print("OK")
""")


def run(code, env=None):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_imports_and_renders_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'autovfx_tpu'):\n"
        "    sys.modules[m] = None  # any import of them now raises\n"
        + RENDER_500
    )
    r = run(code)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_import_needs_no_nvcc():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent", CUDA_PATH="/nonexistent")
    r = run("import sys\n" + RENDER_500, env=env)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_cpu_tensors_never_reach_the_loader(monkeypatch):
    from autovfx_tpu_torch.ops import blend_cuda, fill_cuda, preprocess_cuda
    from autovfx_tpu_torch.core.cameras import look_at_camera
    from autovfx_tpu_torch.train import trainer
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    def refuse(*_):
        raise AssertionError("the CUDA library was asked for on the CPU")

    def launches():
        return (preprocess_cuda.launches, preprocess_cuda.bwd_launches,
                fill_cuda.launches, blend_cuda.launches,
                blend_cuda.train_launches, blend_cuda.bwd_launches)

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    counts = launches()
    g = make_garden_like(3000, seed=2, extent=2.67)
    cam = look_at_camera([2.6, 0.0, 1.4], [0, 0, 0.2], [0, 0, 1],
                         fx=48.0, fy=48.0, width=64, height=48)
    config = autovfx_tpu_torch.RasterConfig(dup_budget=1 << 15, tile=32)
    out = autovfx_tpu_torch.render(g, cam, config=config)
    assert out.rgba.shape == (48, 64, 4)
    state, aux = trainer.train_step(
        trainer.init_state(g), cam, out.rgba[..., :3].flip(0),
        trainer.TrainConfig(raster=config))
    assert state.adam.count == 1 and bool(aux.loss > 0)
    assert counts == launches()


def test_library_hash_follows_sources_and_flags(tmp_path, monkeypatch):
    """The build directory is keyed by the sources and the flags, so an
    edited kernel never loads a stale library."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path()
    (src / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert len({first, _build.library_path()}) == 2


def test_kernel_sources_ship_with_the_package():
    names = {p.name for p in _build.sources()}
    assert {"preprocess.cu", "duplicate.cu", "blend_fwd.cu", "blend_bwd.cu",
            "preprocess_bwd.cu"} <= names
    for name in _build.SIGNATURES:
        text = "".join(p.read_text() for p in _build.sources())
        assert f'extern "C" int {name}(' in text, name


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", os.path.dirname(sys.executable))
    monkeypatch.setattr(_build, "NVCC_FALLBACK", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
