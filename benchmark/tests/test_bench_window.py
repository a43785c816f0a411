"""The window's arithmetic: a rate over all the work and all the time of the
window, a 95th percentile over every request, and a stall that moves both."""

from __future__ import annotations

import itertools

import pytest

from benchmark import harness, loadgen


class FakeClock:
    """A clock that moves only when a request runs."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _closed(durations, seconds):
    clock = FakeClock()
    it = itertools.cycle(durations)

    def call(i):
        clock.t += next(it)
        return i

    return loadgen.run(call, seconds, clock=clock)


def _ctx(window, units):
    return harness.Context("w", window, 1.0, units)


def test_rate_counts_every_request_and_all_the_time():
    w = _closed([0.25], 2.0)
    # requests start at 0, 0.25, ..., 1.75: eight, the last ending at 2.0
    assert len(w.done) == 8 and w.seconds == pytest.approx(2.0)
    assert _ctx(w, 8).rate() == pytest.approx(8 * 8 / 2.0)


def test_last_request_runs_past_the_deadline_and_counts():
    w = _closed([0.3], 1.0)
    # starts at 0, 0.3, 0.6, 0.9: the fourth ends at 1.2, and the window with it
    assert len(w.done) == 4 and w.seconds == pytest.approx(1.2)
    assert _ctx(w, 1).rate() == pytest.approx(4 / 1.2)


def test_percentile_nearest_rank_over_all_samples():
    vals = list(range(1, 101))
    assert loadgen.percentile(vals, 95) == 95
    assert loadgen.percentile(vals[:20], 95) == 19
    assert loadgen.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        loadgen.percentile([], 95)


def test_p95_reader_and_rate_reader(tmp_path):
    from benchmark.harness import load_file

    w = _closed([0.1] * 19 + [1.0], 4.0)
    ctx = _ctx(w, 2)
    p95 = load_file("metrics", "commit_p95_ms").read(ctx)
    lat = sorted(r.latency for r in w.done)
    assert p95 == pytest.approx(lat[-(-len(lat) * 95 // 100) - 1] * 1e3)
    assert load_file("metrics", "msm_points_per_s").read(ctx) == pytest.approx(
        2 * len(w.done) / w.seconds)


def test_a_stall_moves_the_rate_and_the_tail():
    steady = _closed([0.1], 3.0)
    # one request in ten stalls for 0.5 s: the tail and the rate both move
    stalled = _closed([0.1] * 9 + [0.6], 3.0)
    p95 = [loadgen.percentile([r.latency for r in w.done], 95) for w in (steady, stalled)]
    rates = [_ctx(w, 1).rate() for w in (steady, stalled)]
    assert p95[1] > 5 * p95[0]
    assert rates[1] < 0.8 * rates[0]


def test_a_failed_request_stops_the_window():
    def call(i):
        if i == 3:
            raise RuntimeError("CUDA error 700")
        return i

    w = loadgen.run(call, 5.0)
    assert [r.index for r in w.done] == [0, 1, 2]
    assert len(w.failed) == 1 and "700" in w.failed[0].error


def test_latency_runs_from_send_to_return():
    w = _closed([0.2, 0.5], 1.0)
    assert [round(r.latency, 9) for r in w.done] == [0.2, 0.5, 0.2, 0.5]
    assert all(b.start == a.end for a, b in zip(w.done, w.done[1:]))
