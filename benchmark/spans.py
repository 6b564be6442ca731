"""What the readers of the program's own spans and counters share
(``autovfx_tpu_torch.utils.trace``, which records while the profiler of
the traced window records).  Each returns ``None`` untraced, in a cell of
the other kind, or where the program has no such span or counter (a
checkout from before it had them), and the harness then leaves the
metric out.  The records are the process's since it started, which in a
run of ``run.py`` are the traced window's alone."""
from __future__ import annotations

from typing import Optional

from benchmark.harness import Reading


def snapshot(r: Reading, kind: str):
    """The program's trace snapshot, or ``None``."""
    if r.trace is None or r.timing.kind != kind:
        return None
    try:
        from autovfx_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def stream_ms(r: Reading, kind: str, span: str) -> Optional[float]:
    """The span's stream milliseconds a call of the window."""
    snap = snapshot(r, kind)
    if snap is None or span not in snap.spans:
        return None
    return snap.spans[span].stream_s / r.timing.calls * 1e3


def per_call(r: Reading, kind: str, counter: str) -> Optional[float]:
    """The counter over the window's calls."""
    snap = snapshot(r, kind)
    if snap is None or counter not in snap.counters:
        return None
    return snap.counters[counter] / r.timing.calls


def share_pct(r: Reading, kind: str, part: str,
              whole: str) -> Optional[float]:
    """One counter over another (%)."""
    snap = snapshot(r, kind)
    if snap is None or not snap.counters.get(whole) \
            or part not in snap.counters:
        return None
    return 100.0 * snap.counters[part] / snap.counters[whole]
