"""The windows' arithmetic: every call in the window is counted in the
rate and in the percentile, on a fake clock."""
from __future__ import annotations

import statistics

import pytest

from benchmark import harness, readers


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class Sess:
    """Calls whose issue and sync take set times on the fake clock."""

    def __init__(self, kind, clock, issue, sync):
        self.kind, self.clock, self.issue, self.sync_s = kind, clock, issue, sync
        self.period, self.seen_calls = 4, []

    def call(self, i):
        self.clock.t += self.issue[i % len(self.issue)]
        return i

    def sync(self):
        self.clock.t += self.sync_s[len(self.seen_calls) % len(self.sync_s)]

    def seen(self, i, out):
        self.seen_calls.append(out)


@pytest.mark.parametrize("whole", [0, 4])
def test_frames_rate_and_p95_count_every_frame(monkeypatch, whole):
    clock = FakeClock()
    monkeypatch.setattr(harness, "_now", clock)
    s = Sess("frames", clock, [0.004, 0.006, 0.005], [0.002, 0.001, 0.009])
    t = harness.window(s, 1.0, s.sync, whole_passes=whole)
    assert s.seen_calls == list(range(t.calls))
    assert len(t.latencies_s) == t.calls == len(t.issues_s)
    assert sum(t.latencies_s) == pytest.approx(t.window_s)
    assert t.window_s >= 1.0 and t.window_s - max(t.latencies_s) < 1.0
    if whole:
        assert t.calls % whole == 0
    r = harness.Reading(t, 1.0, 1, None, {})
    assert readers.rate(r, "frames") == pytest.approx(t.calls / t.window_s)
    want = statistics.quantiles(t.latencies_s, n=20, method="inclusive")[-1]
    assert readers.latency_p95_ms(r) == pytest.approx(want * 1e3)
    assert readers.rate(r, "steps") is None


def test_steps_window_closes_at_the_sync(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(harness, "_now", clock)
    s = Sess("steps", clock, [0.01], [0.5])
    t = harness.window(s, 1.0, s.sync)
    assert t.calls == 100  # issues until the host clock passes 1 s
    assert t.window_s == pytest.approx(1.5)
    r = harness.Reading(t, 1.0, 1, None, {})
    assert readers.rate(r, "steps") == pytest.approx(100 / 1.5)
    assert readers.latency_p95_ms(r) is None


def test_p95_of_a_hundred():
    vals = [float(i) for i in range(1, 101)]
    assert harness.p95(vals) == pytest.approx(95.05)
