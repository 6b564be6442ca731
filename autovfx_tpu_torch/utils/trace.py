"""Spans and counters at the port's layer boundaries, on the profiler's
clock.

Spans and device counters record exactly while a torch profiler session
records: ``torch.autograd.profiler._is_profiler_enabled``, read through
the module on every call, is the one switch, the one an operator throws
to get a trace.  Off, ``span`` returns one shared no-op context manager
and ``count_device`` returns at once: nothing is allocated or recorded.

On, ``with span(name):`` keeps the span's name, its host start and end
(``time.perf_counter``), its parent (the innermost span open on its
thread) and its call id, the sequence number of its root span, so the
spans of one frame or step share it.  It enters
``torch.profiler.record_function(name)``, so the span sits in the
profiler's trace on the host clock the device records are aligned with.
Once CUDA is initialized it records a pair of pooled timing events on
the current stream, whose elapsed time is the span's stream time: the
device time from the stream reaching the span's start to reaching its
end, any wait for the host's issue inside the span included.  Without
CUDA, stream time is the host duration.  While the current stream
captures a CUDA graph a span records nothing, so inside a replayed graph
only the span around the replay exists.

A root span, on the card, also counts the synchronizing CUDA calls made
inside it as ``host_waits``: ``torch.cuda.set_sync_debug_mode("warn")``
for its extent, its warnings caught and counted rather than printed (the
autograd engine replays its backward thread's warnings on the caller),
then the mode restored.  Under a mode of "error" nothing is counted.

``count(name, n)`` keeps host integers and is always on (the kernel
wrappers' ``launch.<kernel>`` counts); ``count_device(name, t)`` adds a
device scalar into a device accumulator with no sync, only when on.
Records stay in memory: ``snapshot()`` synchronizes once, resolves the
events and caches the result, and ``reset()`` clears everything.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

SYNC_WARNING = "called a synchronizing CUDA operation"
_NULL = contextlib.nullcontext()


class SpanStats(NamedTuple):
    """One span name's records summed (seconds)."""

    calls: int
    host_s: float
    stream_s: float
    self_stream_s: float  # stream time less that of its direct children


class Record(NamedTuple):
    """One span, resolved."""

    name: str
    parent: Optional[int]  # index of the parent's record, None for a root
    call: int  # the sequence number of its root
    host_start: float
    host_end: float
    stream_s: float


class Snapshot(NamedTuple):
    spans: dict  # name -> SpanStats
    counters: dict  # name -> int: host counters, device counters, host_waits
    records: list  # Record, in the order the spans opened


def enabled() -> bool:
    """A torch profiler session records."""
    return _profiler._is_profiler_enabled


def _on_card() -> bool:
    return torch.cuda.is_initialized()


def _recording() -> bool:
    """On, and the current stream captures no graph."""
    if not _profiler._is_profiler_enabled:
        return False
    return not (_on_card() and torch.cuda.is_current_stream_capturing())


class _Tracer:
    """The process's records: one instance, behind the module's functions."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.local = threading.local()
        self.pool: list = []  # timing events free for reuse
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.spans: list = []  # _Span, in the order they opened
            self.counters: dict = {}
            self.device: dict = {}  # name -> device accumulator
            self.roots = itertools.count()
            self.cached: Optional[Snapshot] = None

    def stack(self) -> list:
        """The spans open on this thread, innermost last."""
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, span: "_Span") -> int:
        with self.lock:
            self.spans.append(span)
            self.cached = None
            return len(self.spans) - 1

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n
            self.cached = None

    def count_device(self, name: str, t: torch.Tensor) -> None:
        with self.lock:
            acc = self.device.get(name)
            if acc is None:
                self.device[name] = t.detach().clone()
            else:
                acc.add_(t.detach())
            self.cached = None

    def events(self) -> tuple:
        with self.lock:
            if len(self.pool) >= 2:
                return self.pool.pop(), self.pool.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def snapshot(self) -> Snapshot:
        with self.lock:
            if self.cached is not None:
                return self.cached
            if any(s.host_end is None for s in self.spans):
                raise RuntimeError("trace.snapshot() with a span open")
            if any(s.ev is not None for s in self.spans):
                torch.cuda.synchronize()
            for s in self.spans:
                if s.ev is not None:
                    s.stream_s = s.ev[0].elapsed_time(s.ev[1]) / 1e3
                    self.pool += s.ev
                    s.ev = None
            records = [Record(s.name, s.parent, s.call, s.host_start,
                              s.host_end, s.stream_s) for s in self.spans]
            child_s = [0.0] * len(records)
            for r in records:
                if r.parent is not None:
                    child_s[r.parent] += r.stream_s
            spans: dict = {}
            for r, c in zip(records, child_s):
                x = spans.get(r.name, SpanStats(0, 0.0, 0.0, 0.0))
                spans[r.name] = SpanStats(
                    x.calls + 1, x.host_s + r.host_end - r.host_start,
                    x.stream_s + r.stream_s, x.self_stream_s + r.stream_s - c)
            counters = dict(self.counters)
            for name, acc in self.device.items():
                counters[name] = counters.get(name, 0) + int(acc.item())
            self.cached = Snapshot(spans, counters, records)
            return self.cached


_TRACER = _Tracer()


class _Span:
    """A recording span and, once closed, its record; made only while on."""

    __slots__ = ("name", "parent", "call", "host_start", "host_end",
                 "stream_s", "ev", "index", "fn", "waits", "caught",
                 "prev_mode")

    def __init__(self, name: str) -> None:
        self.name = name
        self.parent = None
        self.host_end = None
        self.ev = None
        self.waits = None

    def __enter__(self) -> "_Span":
        stack = _TRACER.stack()
        card = _on_card()
        if stack:
            self.parent, self.call = stack[-1].index, stack[-1].call
        else:
            self.call = next(_TRACER.roots)
            if card:
                self._catch_waits()
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        if card:
            self.ev = _TRACER.events()
            self.ev[0].record()
        self.index = _TRACER.add(self)
        stack.append(self)
        self.host_start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        _TRACER.stack().pop()
        try:
            if self.ev is not None:
                self.ev[1].record()
            self.fn.__exit__(*exc)
        finally:
            if self.waits is not None:
                self._count_waits()
            self.stream_s = end - self.host_start  # the events replace it
            self.host_end = end
            _TRACER.cached = None

    def _catch_waits(self) -> None:
        """Turn the sync debug mode to "warn" (unless "error") and catch
        every warning until the span ends."""
        self.prev_mode = torch.cuda.get_sync_debug_mode()
        if self.prev_mode == 2:
            return
        torch.cuda.set_sync_debug_mode(1)  # its own warning passes as usual
        self.waits = warnings.catch_warnings(record=True)
        self.caught = self.waits.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)

    def _count_waits(self) -> None:
        """Restore the mode, count the sync warnings and pass on the rest
        (the sync ones too, where the mode was "warn" before)."""
        self.waits.__exit__(None, None, None)
        torch.cuda.set_sync_debug_mode(self.prev_mode)
        n = 0
        for w in self.caught:
            sync = str(w.message).startswith(SYNC_WARNING)
            n += sync
            if not sync or self.prev_mode == 1:
                warnings.showwarning(w.message, w.category, w.filename,
                                     w.lineno, w.file, w.line)
        _TRACER.count("host_waits", n)


def span(name: str):
    """A span of ``name`` while on; else the shared no-op."""
    if not _recording():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` (always on)."""
    _TRACER.count(name, n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the device scalar ``t`` to the accumulator ``name``, with no
    sync, while on."""
    if _recording():
        _TRACER.count_device(name, t)


def counters() -> dict:
    """The host counters as they stand (no sync; no device counter)."""
    with _TRACER.lock:
        return dict(_TRACER.counters)


def snapshot() -> Snapshot:
    """Every span name's calls and host, stream and self stream seconds,
    and every counter, over the records since the last ``reset``."""
    return _TRACER.snapshot()


def reset() -> None:
    """Drop every record and counter."""
    _TRACER.reset()
