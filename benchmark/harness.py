"""The benchmark's harness: finds a cell by name in ``BENCHMARK.json``,
runs its set-up, its timed or traced window and its check, and builds
the result line.

Everything particular to a cell sits in files of its own, found by name:
``configs/<config>.json`` (the ``file`` of its configuration), the
traffic mix ``traffic/<traffic>.json``, the entry the mix drives
``entries/<entry>.py`` and each metric's reader ``metrics/<metric>.py``.
A later cell, mix, entry or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.

An entry module has ``setup(ctx) -> session``.  A session has ``kind``
("frames": one client in a closed loop, each call synchronized; or
"steps": calls issued back to back, synchronized at the window's end),
``call(i)`` (issue call ``i`` of the window, return its output),
``seen(i, out)`` (keep what the check needs; host work only),
``release()`` (drop the program's state) and ``finish(trace)``, which
runs the plain reference and returns ``Finish``.  A metric module has
``read(r) -> float | None`` over a ``Reading``; ``None`` leaves the
metric out of the line.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "autovfx_tpu")
TRACE_SECONDS = 3.0  # the traced window, at most (whole passes)
PROFILE_PAD_S = 0.5  # idle seconds at each end of the profiler session
SPIN_CYCLES = 200_000_000  # the session's opening marker kernel, ~0.1 s
TOP = 10  # entries of each breakdown list


def use_cache_dirs(root: Path = ROOT) -> None:
    """Point Triton, PyTorch extensions and the inductor at fixed
    directories under ``build/`` inside the checkout (the program builds
    its own nvcc library under ``build/kernels/``), before torch loads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(root / "build" / sub)


# ---- the manifest --------------------------------------------------------------


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: object
    end_to_end: list  # the manifest's metric entries this cell reports
    per_layer: list
    readers: dict  # metric name -> read(r)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_names(root: Path = ROOT) -> list[str]:
    return [w["name"] for w in manifest(root)["workloads"]]


def _reports(metric: dict, cell: str, e2e_here: Optional[set]) -> bool:
    """Does ``cell`` report ``metric``: it is listed in the metric's
    ``workloads``, or the metric has none and (a per-layer metric) the
    end-to-end metric it moves is reported here."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_here is None or metric["moves"] in e2e_here


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, entry module
    and metric readers, all found by name under ``benchmark/``."""
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    bench = root / "benchmark"
    with open(bench / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    entry = load_module(bench / "entries" / f"{traffic['entry']}.py",
                        f"benchmark_entry_{traffic['entry']}")
    e2e = [x for x in m["end_to_end"] if _reports(x, name, None)]
    here = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"] if _reports(x, name, here)]
    readers = {x["name"]: load_module(bench / "metrics" / f"{x['name']}.py",
                                      "benchmark_metric_"
                                      + x["name"].replace(".", "_")).read
               for x in e2e + layer}
    return Cell(name, w["chips"], config, traffic, entry, e2e, layer,
                readers)


# ---- the import guard ----------------------------------------------------------


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is one of ``FORBIDDEN``, compared
    whole (``autovfx_tpu_torch`` is not ``autovfx_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---- the windows ---------------------------------------------------------------


class Timing(NamedTuple):
    kind: str
    calls: int
    window_s: float
    latencies_s: list  # frames: each call's issue to its synchronize
    issues_s: list  # each call's issue to its return
    starts_s: list  # each call's issue, from the window's start

    def per_second(self) -> list:
        """Calls issued in each whole second of the window."""
        counts = [0] * max(int(self.window_s), 1)
        for t in self.starts_s:
            if int(t) < len(counts):
                counts[int(t)] += 1
        return counts


def _now() -> float:
    return time.perf_counter()


def window(sess, seconds: float, sync: Callable[[], None],
           span: Optional[Callable[[str], object]] = None,
           whole_passes: int = 0) -> Timing:
    """Calls of ``sess`` until the host clock has run ``seconds`` (in whole
    passes of ``whole_passes`` calls when given).  Frames: each call is
    synchronized, its latency taken from issue to synchronize, and the
    window ends at the last synchronize.  Steps: calls back to back, one
    synchronize at the end, which closes the window."""
    import contextlib

    span = span or (lambda name: contextlib.nullcontext())
    lat, issue, starts = [], [], []
    frames = sess.kind == "frames"
    i = 0
    start = _now()
    end = start
    while True:
        t0 = _now()
        with span("bench.call"):
            out = sess.call(i)
        t1 = _now()
        if frames:
            with span("bench.sync"):
                sync()
            end = _now()
            lat.append(end - t0)
        issue.append(t1 - t0)
        starts.append(t0 - start)
        sess.seen(i, out)
        i += 1
        done = (end if frames else t1) - start >= seconds
        if done and (not whole_passes or i % whole_passes == 0):
            break
    if not frames:
        with span("bench.sync"):
            sync()
        end = _now()
    return Timing(sess.kind, i, end - start, lat, issue, starts)


def p95(values: list) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


# ---- the trace -----------------------------------------------------------------


class Trace(NamedTuple):
    """The traced window as the profiler saw it (seconds)."""

    window_s: float
    busy_s: float
    kernel_s: dict  # device op name -> seconds in the window
    idle_gaps: list  # [label, seconds], longest first
    lost: int  # kernel launches with no device record
    launches: int


def short_name(name: str) -> str:
    """A device op's name without ``void``, anonymous namespaces and its
    argument list, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:96]


def read_trace(events, device_type) -> Trace:
    """Busy time, device time by op and idle gaps inside the
    ``bench.window`` span, from the profiler's kineto events."""
    cpu = [e for e in events if e.device_type() != device_type]
    dev = [e for e in events if e.device_type() == device_type
           and not e.is_user_annotation() and "spin_kernel" not in e.name()]
    win = [e for e in cpu if e.name() == "bench.window"]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    intervals, kernel_s = [], {}
    for e in dev:
        a = max(e.start_ns(), w0)
        b = min(e.start_ns() + e.duration_ns(), w1)
        if b <= a:
            continue
        intervals.append((a, b))
        k = short_name(e.name())
        kernel_s[k] = kernel_s.get(k, 0.0) + (b - a) / 1e9
    intervals.sort()
    busy, gaps, cur = 0, [], w0
    for a, b in intervals:
        if a > cur:
            gaps.append((a - cur, cur))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((w1 - cur, cur))
    gaps.sort(reverse=True)
    host = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in cpu if e.name() != "bench.window"))
    starts = [h[0] for h in host]
    labelled = []
    for length, t in gaps[:TOP]:
        labelled.append([_host_label(host, starts, t), length / 1e9])
    seen = {e.correlation_id() for e in dev}
    launches = [e for e in cpu if "LaunchKernel" in e.name()
                and w0 <= e.start_ns() <= w1]
    lost = sum(e.correlation_id() not in seen for e in launches)
    return Trace((w1 - w0) / 1e9, busy / 1e9, kernel_s, labelled, lost,
                 len(launches))


def _host_label(host, starts, t: int) -> str:
    """The benchmark span the host was in at ``t`` and, inside it, the
    innermost host op ("bench.call > aten::nonzero")."""
    span, inner = "bench.loop", None
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0:
        a, b, name = host[j]
        if a <= t < b:
            if name.startswith("bench."):
                span = name
                break
            if inner is None:
                inner = name
        j -= 1
    return f"{span} > {inner}"[:96] if inner else span


def traced_window(sess, seconds: float, period: int, cuda: bool):
    """The window under ``torch.profiler`` in whole passes: (``Timing``,
    ``Trace``).  The session is padded with idle time and opens with a
    spin kernel, since the profiler keeps only the device records inside
    it on the host's clock, which drifts from the card's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        if cuda:
            torch.cuda._sleep(SPIN_CYCLES)
            sync()
        with record_function("bench.window"):
            timing = window(sess, seconds, sync, record_function, period)
        time.sleep(PROFILE_PAD_S)
    return timing, read_trace(prof.profiler.kineto_results.events(),
                              DeviceType.CUDA)


# ---- a run ---------------------------------------------------------------------


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Finish(NamedTuple):
    """What an entry's check returns: the numbers compared, the calls
    that failed (a render past its duplicate budget), and, traced, the
    counted work of one call by kernel (``work`` tuples)."""

    checks: list
    failed: int
    work: dict


class Reading(NamedTuple):
    """What a metric reader reads."""

    timing: Timing
    setup_s: float
    peak_bytes: int
    trace: Optional[Trace]
    work: dict


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return None
    return up - start / os.sysconf("SC_CLK_TCK")


class Context(NamedTuple):
    """What an entry's set-up is given."""

    config: dict
    traffic: dict
    seed: int
    device: object  # torch.device


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        started: float, log=lambda s: print(s, file=sys.stderr,
                                             flush=True)) -> dict:
    """Set-up, window, check: the result line as a dict.  ``started`` is
    the host clock (``time.perf_counter``) at the process's start."""
    import torch

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    sess = cell.entry.setup(Context(cell.config, cell.traffic, seed, device))
    sync()
    setup_s = _now() - started
    log(f"set-up {setup_s:.3f} s")
    if trace:
        timing, tr = traced_window(sess, min(seconds, TRACE_SECONDS),
                                   sess.period, cuda)
        log(f"traced window {timing.calls} calls in {timing.window_s:.3f} s;"
            f" {tr.lost} of {tr.launches} kernel launches without a device "
            "record")
    else:
        timing, tr = window(sess, seconds, sync), None
        log(f"window {timing.calls} calls in {timing.window_s:.3f} s; by "
            f"second {timing.per_second()}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"loaded after the window: {bad}")
    sess.release()
    t0 = _now()
    fin = sess.finish(trace)
    log(f"reference check {_now() - t0:.3f} s")
    r = Reading(timing, setup_s, peak, tr, fin.work)
    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[spec["name"]](r)
        if v is not None:
            metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(fin.checks) and all(c.ok for c in fin.checks),
           "attempted": timing.calls, "failed": int(fin.failed),
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        ops = sorted(tr.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                            "idle_gaps": tr.idle_gaps}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in fin.checks}
    return out
