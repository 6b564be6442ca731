"""``autovfx_tpu_torch.utils.trace`` on the CPU: off it records and
allocates nothing; on, under a CPU profiler session, a tiny training
step, coarse SuGaR step and edited frame give the span tree of the
layer boundaries (parents, call ids, self time) and the profiler sees
each span; the counters; and the benchmark's readers of them
(``benchmark/spans.py``) over a known snapshot."""
import dataclasses
import time
import tracemalloc
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from autovfx_tpu_torch.core.cameras import look_at_camera, stack_cameras
from autovfx_tpu_torch.ops.rasterize import RasterConfig
from autovfx_tpu_torch.utils import trace
from autovfx_tpu_torch.utils.synthetic import make_garden_like
from benchmark import harness

W, H = 48, 32
CONFIG = RasterConfig(dup_budget=1 << 14, tile=16)


def camera(angle: float = 0.0):
    return look_at_camera([2.6 * np.cos(angle), 2.6 * np.sin(angle), 1.4],
                          [0, 0, 0.2], [0, 0, 1], fx=36.0, fy=36.0, width=W,
                          height=H, device="cpu")


@pytest.fixture(scope="module")
def scene():
    torch.manual_seed(0)
    return make_garden_like(800, seed=3, extent=1.0, device="cpu")


@pytest.fixture(autouse=True)
def clean():
    trace.reset()
    yield
    trace.reset()


def traced(fn):
    """``fn()`` under a CPU profiler session: (its result, the snapshot,
    the profiler's event names)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, trace.snapshot(), {e.name for e in prof.events()}


def tree(snap) -> set:
    """(name, parent name) of every record."""
    return {(r.name, None if r.parent is None else snap.records[r.parent].name)
            for r in snap.records}


def test_off_records_and_allocates_nothing():
    assert not trace.enabled()
    assert trace.span("step") is trace.span("frame")
    trace.count_device("raster.dups", torch.tensor(5))
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("step"):
                with trace.span("step.loss"):
                    pass
            trace.count_device("raster.dups", torch.tensor(5))
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = tracemalloc.Filter(True, trace.__file__)
    grown = [s for s in after.filter_traces([here]).compare_to(
        before.filter_traces([here]), "filename") if s.size_diff > 0]
    assert not grown, grown
    snap = trace.snapshot()
    assert snap.records == [] and snap.spans == {} and snap.counters == {}


def test_train_step_tree(scene):
    from autovfx_tpu_torch.train import trainer as T

    cfg = T.TrainConfig(raster=CONFIG, spatial_lr_scale=1.0)
    state = T.init_state(scene)
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(1))

    def two_steps():
        s, _ = T.train_step(state, camera(0.0), target, cfg)
        return T.train_step(s, camera(1.0), target, cfg)

    _, snap, names = traced(two_steps)
    assert tree(snap) == {("step", None), ("raster", "step"),
                          ("raster.binning", "raster"), ("step.loss", "step"),
                          ("step.backward", "step"), ("step.adam", "step")}
    roots = [r for r in snap.records if r.parent is None]
    assert [r.call for r in roots] == [0, 1]
    for r in snap.records:  # each span in its root's step
        root = r
        while root.parent is not None:
            root = snap.records[root.parent]
        assert r.call == root.call
        assert root.host_start <= r.host_start <= r.host_end <= root.host_end
    assert {n: s.calls for n, s in snap.spans.items()} == dict.fromkeys(
        ("step", "raster", "raster.binning", "step.loss", "step.backward",
         "step.adam"), 2)
    assert set(snap.spans) <= names  # each span is a profiler annotation
    assert snap.counters["raster.slots"] == 2 * CONFIG.dup_budget
    assert 0 < snap.counters["raster.dups"] <= 2 * CONFIG.dup_budget
    assert "host_waits" not in snap.counters  # counted on the card only


def test_coarse_step_density_span(scene):
    from autovfx_tpu_torch.sugar import coarse_train as CT
    from autovfx_tpu_torch.sugar import density
    from autovfx_tpu_torch.train import trainer as T

    g = dataclasses.replace(scene, opacity_logit=torch.zeros_like(
        scene.opacity_logit))
    density.reset_neighbors(g, k=4)
    cfg = CT.SugarConfig(base=T.TrainConfig(raster=CONFIG,
                                            spatial_lr_scale=1.0),
                         sdf_mode="density", regularize_from=0,
                         n_sdf_samples=64)
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(2))
    _, snap, names = traced(lambda: CT.coarse_step(
        T.init_state(g), camera(), target, cfg, True,
        torch.Generator().manual_seed(0)))
    assert ("sugar.density", "step") in tree(snap)
    assert {n: s.calls for n, s in snap.spans.items()}["raster"] == 2
    assert "sugar.density" in names
    # the CPU takes the field's twin: no kernel launch is counted
    assert not [k for k in snap.counters if k.startswith("launch.density")]


def edit_inputs(scene, effects: bool = False):
    """A cube's eight corner surfels over ``scene`` for two frames and, with
    ``effects``, an 8³ adaptive smoke and fire volume and the corners
    melting."""
    from autovfx_tpu_torch.render import clip, liquid, smoke

    corners = np.array([[x, y, z] for x in (-.3, .3) for y in (-.3, .3)
                        for z in (-.3, .3)], np.float32)
    surf = {"points": corners, "normals": corners, "colors": corners,
            "radius": np.float32(0.1)}
    hull = type("Hull", (), {"planes": np.zeros((1, 8, 4), np.float32),
                             "plane_mask": np.ones((1, 8), bool)})()
    fx = {}
    if effects:
        s_cfg = smoke.SmokeConfig(resolution=8, with_fire=True)
        states, cells = smoke.simulate_smoke(
            s_cfg, smoke.sphere_inflow(s_cfg, [4, 4, 2], 2.0, device="cpu"),
            2, adaptive=True)
        mf = liquid.MeltSim(corners, ground_z=-0.3,
                            cfg=liquid.LiquidConfig(resolution=8, substeps=2),
                            device="cpu").run([0.5, 1.0])
        fx = {"smoke_traj": (states, np.array([-1.0, -1.0, -0.3], np.float32),
                             2.0, s_cfg, cells),
              "melt": {"pos": mf.tracer_pos, "norm": mf.tracer_norm,
                       "mask": np.ones(8, bool)}}
    return clip.build_clip_inputs(
        scene, stack_cameras([camera(), camera(1.0)]), [{}], [surf],
        np.zeros((2, 1, 3)), np.tile(np.eye(3), (2, 1, 1, 1)), hull,
        np.ones((4, 8, 3), np.float32), num_lights=2, device="cpu", **fx)


def test_edited_frame_tree(scene):
    from autovfx_tpu_torch.render import clip

    inp = edit_inputs(scene)
    with torch.no_grad():
        _, snap, names = traced(lambda: [
            clip.render_edited_frame_fused(inp, i, CONFIG) for i in (0, 1)])
    assert tree(snap) == {("frame", None), ("frame.shading", "frame"),
                          ("raster", "frame"), ("raster.binning", "raster"),
                          ("frame.shadow", "frame")}
    assert sorted({r.call for r in snap.records}) == [0, 1]
    assert {"frame", "frame.shading", "frame.shadow", "raster",
            "raster.binning"} <= names


def test_frame_without_smoke_records_no_effects_span(scene):
    from autovfx_tpu_torch.render import clip

    inp = edit_inputs(scene)
    with torch.no_grad():
        _, snap, names = traced(lambda: clip.render_edited_frame_fused(
            inp, 0, CONFIG))
    assert not {"frame.smoke", "frame.fire"} & (set(snap.spans) | names)
    assert not {"smoke.splats", "smoke.slots"} & set(snap.counters)


def test_effects_frame_tree_and_counters(scene):
    from autovfx_tpu_torch.render import clip

    inp = edit_inputs(scene, effects=True)
    with torch.no_grad():
        _, snap, names = traced(lambda: [
            clip.render_edited_frame_fused(inp, i, CONFIG) for i in (0, 1)])
        sets = [clip.smoke_gaussians(inp, i)[0] for i in (0, 1)]
    assert tree(snap) == {("frame", None), ("frame.shading", "frame"),
                          ("frame.smoke", "frame"), ("raster", "frame"),
                          ("raster.binning", "raster"),
                          ("frame.shadow", "frame"), ("frame.fire", "frame"),
                          ("raster", "frame.fire")}
    recs = snap.records
    for r in recs:  # every span carries its frame's call id
        if r.parent is not None:
            assert r.call == recs[r.parent].call
    assert sorted(r.call for r in recs if r.name == "frame.fire") == [0, 1]
    assert {n: s.calls for n, s in snap.spans.items()}["raster"] == 4
    assert {"frame.smoke", "frame.fire"} <= names
    live = sum(int(g.active.sum()) for g in sets)
    assert live > 0
    assert snap.counters["smoke.splats"] == live
    assert snap.counters["smoke.slots"] == sum(g.capacity for g in sets)


def test_effects_frame_off_records_nothing(scene):
    from autovfx_tpu_torch.render import clip

    inp = edit_inputs(scene, effects=True)
    with torch.no_grad():
        clip.render_edited_frame_fused(inp, 1, CONFIG)
    snap = trace.snapshot()
    assert snap.records == [] and snap.spans == {}
    assert not {"smoke.splats", "smoke.slots"} & set(snap.counters)


def test_self_time_is_duration_less_children():
    def nested():
        with trace.span("step"):
            time.sleep(0.002)
            with trace.span("step.loss"):
                time.sleep(0.004)
            with trace.span("step.adam"):
                time.sleep(0.003)

    _, snap, _ = traced(lambda: [nested() for _ in range(2)])
    recs = snap.records
    kids = sum(r.stream_s for r in recs if r.parent is not None)
    step = snap.spans["step"]
    assert step.calls == 2
    assert step.self_stream_s == pytest.approx(step.stream_s - kids)
    assert step.self_stream_s >= 0.004 - 1e-4
    for name in ("step.loss", "step.adam"):  # leaves: self time is all
        s = snap.spans[name]
        assert s.self_stream_s == s.stream_s
    # without CUDA, stream time is the host duration
    assert step.stream_s == pytest.approx(step.host_s)


def test_count_device_sums_without_sync(monkeypatch):
    def host_read(*_):
        raise AssertionError("count_device read the device")

    with profile(activities=[ProfilerActivity.CPU]):
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "item", host_read)
            m.setattr(torch.Tensor, "tolist", host_read)
            m.setattr(torch.cuda, "synchronize", host_read)
            for n in (3, 4, 5):
                trace.count_device("raster.dups", torch.tensor(n))
        trace.count("raster.slots", 10)
    assert trace.snapshot().counters == {"raster.dups": 12,
                                         "raster.slots": 10}
    trace.count("launch.preprocess")  # host counters: always on
    assert trace.counters() == {"raster.slots": 10, "launch.preprocess": 1}


def test_host_waits_counts_sync_warnings(monkeypatch):
    """The root's count: the sync warnings are counted and kept quiet,
    any other warning passes on."""
    mode = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", mode.append)
    root = trace._Span("step")
    with pytest.warns(UserWarning, match="unrelated") as seen:
        root._catch_waits()
        for _ in range(3):
            warnings.warn(trace.SYNC_WARNING + ", e.g. a copy")
        warnings.warn("unrelated")
        root._count_waits()
    assert mode == [1, 0]
    assert [str(w.message) for w in seen] == ["unrelated"]
    assert trace.counters() == {"host_waits": 3}


# ---- the benchmark's readers -------------------------------------------------

FRAME_READERS = {"shading_ms.frames": 2.0, "shadow_ms.frames": 4.0,
                 "binning_ms.frames": 1.0, "dup_fill.frames": 80.0,
                 "host_waits.frames": 3.0, "smoke_ms.frames": 3.0,
                 "fire_ms.frames": 5.0, "smoke_fill.frames": 25.0}
STEP_READERS = {"loss_ms.train": 2.0, "backward_ms.train": 4.0,
                "adam_ms.train": 1.0, "density_ms.train": 8.0,
                "host_waits.train": 2.5}


def reader(name: str):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "trace_test_" + name.replace(".", "_")).read


def reading(kind: str, traced: bool, calls: int = 4) -> harness.Reading:
    timing = harness.Timing(kind, calls, 1.0, [], [0.01] * calls, [])
    tr = harness.Trace(1.0, 0.5, {}, [], 0, 0) if traced else None
    return harness.Reading(timing, 1.0, 0, tr, {})


def known_snapshot() -> trace.Snapshot:
    def stats(total_s):
        return trace.SpanStats(4, total_s, total_s, total_s)

    spans = {"frame.shading": stats(0.008), "frame.shadow": stats(0.016),
             "raster.binning": stats(0.004), "step.loss": stats(0.008),
             "step.backward": stats(0.016), "step.adam": stats(0.004),
             "sugar.density": stats(0.032), "frame.smoke": stats(0.012),
             "frame.fire": stats(0.020)}
    return trace.Snapshot(spans, {"raster.dups": 800, "raster.slots": 1000,
                                  "smoke.splats": 100, "smoke.slots": 400,
                                  "host_waits": {"frames": 12,
                                                 "steps": 10}}, [])


@pytest.mark.parametrize("name,want", [*FRAME_READERS.items(),
                                       *STEP_READERS.items()])
def test_reader(monkeypatch, name, want):
    kind = "frames" if name in FRAME_READERS else "steps"
    other = "steps" if kind == "frames" else "frames"
    snap = known_snapshot()
    snap.counters["host_waits"] = snap.counters["host_waits"][kind]
    monkeypatch.setattr(trace, "snapshot", lambda: snap)
    read = reader(name)
    assert read(reading(kind, traced=False)) is None
    assert read(reading(other, traced=True)) is None
    assert read(reading(kind, traced=True)) == pytest.approx(want)
    monkeypatch.setattr(trace, "snapshot", lambda: trace.Snapshot({}, {}, []))
    assert read(reading(kind, traced=True)) is None  # nothing to read
