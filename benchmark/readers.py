"""Arithmetic the metric readers share.  Each returns ``None`` where the
run holds nothing to read (no trace, another kind of cell, no device
record of the kernel), and the harness then leaves the metric out."""
from __future__ import annotations

from typing import Optional

from benchmark import work
from benchmark.harness import Reading, p95

# kernel name prefixes in the profiler's records (``void`` stripped)
KERNELS = {"blend_fwd": "blend_kernel<", "blend_bwd": "blend_bwd_kernel<"}


def rate(r: Reading, kind: str) -> Optional[float]:
    """Calls completed over the whole window, a second."""
    if r.trace is not None or r.timing.kind != kind:
        return None
    return r.timing.calls / r.timing.window_s


def latency_p95_ms(r: Reading) -> Optional[float]:
    if r.trace is not None or not r.timing.latencies_s:
        return None
    return p95(r.timing.latencies_s) * 1e3


def issue_ms(r: Reading, kind: str) -> Optional[float]:
    """The host's mean milliseconds from a call to its return."""
    if r.trace is None or r.timing.kind != kind:
        return None
    return sum(r.timing.issues_s) / len(r.timing.issues_s) * 1e3


def idle_pct(r: Reading, kind: str) -> Optional[float]:
    """The traced window's share in which no device record ran."""
    if r.trace is None or r.timing.kind != kind or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def kernel_s(r: Reading, prefix: str) -> float:
    return sum(s for name, s in r.trace.kernel_s.items()
               if name.startswith(prefix))


def roofline_pct(r: Reading, kind: str, kernel: str) -> Optional[float]:
    """The kernel's least time for its counted work over its measured
    device time, a call."""
    if r.trace is None or r.timing.kind != kind or kernel not in r.work:
        return None
    spent = kernel_s(r, KERNELS[kernel])
    if spent <= 0:
        return None
    return 100.0 * work.bound_s(r.work[kernel]) / (spent / r.timing.calls)


def mfu_pct(r: Reading, kind: str) -> Optional[float]:
    """The summed least time of every counted kernel's work over the
    call's time in the traced window."""
    if r.trace is None or r.timing.kind != kind or not r.work \
            or r.trace.busy_s <= 0:
        return None
    least = sum(work.bound_s(w) for w in r.work.values())
    return 100.0 * least / (r.timing.window_s / r.timing.calls)
