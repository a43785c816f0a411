"""The per-layer metrics that read the program's own recording
(``benchmark/recording.py``: ``kernel_launches_per_batch``,
``host_copies_per_batch``, ``host_copies_per_commit``,
``host_serial_ms_per_batch``) on a toy recording made in a CPU profiler
session, and None where there is nothing to read: an untraced run, no
recording, a program without ``utils/tracing.py``."""

from __future__ import annotations

import sys
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, loadgen, trace
from snarkos_tpu_torch.utils import tracing

READERS = ("kernel_launches_per_batch", "host_copies_per_batch", "host_copies_per_commit",
           "host_serial_ms_per_batch")


def _ctx(requests=2, traced=True):
    summary = trace.TraceSummary(requests, 1.0, 0.5, 10, 2, 0) if traced else None
    return harness.Context("toy-cell", loadgen.Window(0.0, 1.0), 0.1, 8, summary)


def _read(name, ctx):
    return harness.load_file("metrics", name).read(ctx)


@pytest.fixture
def toy_recording(monkeypatch):
    """Two toy requests: launches, copies and nested host spans counted
    inside a profiler session, one launch and one copy before it."""
    monkeypatch.setattr(tracing, "_COUNTS", {})
    tracing.count("launch.k")
    tracing.count("copy.before")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with tracing.span("prove.batch", "toy"):
                tracing.count("launch.k", 4)
                tracing.count("launch.j")
                tracing.count("copy.a", 2)
                with tracing.span("host.decode", "toy"):
                    with tracing.span("host.inner", "toy"):
                        time.sleep(0.002)
                with tracing.span("sync.read", "toy"):
                    tracing.count("copy.b")
    tracing.count("copy.after")
    return tracing.recording()


def test_the_readers_read_the_recording(toy_recording):
    ctx = _ctx()
    assert _read("kernel_launches_per_batch", ctx) == 5.0
    assert _read("host_copies_per_batch", ctx) == _read("host_copies_per_commit", ctx) == 3.0
    outer = [s for s in toy_recording.spans if s.phase == "host.decode"]
    want = sum(s.end_ns - s.start_ns for s in outer) * 1e-6 / 2
    assert _read("host_serial_ms_per_batch", ctx) == pytest.approx(want)
    assert want >= 2 * 2.0 / 2


def test_nothing_to_read_gives_none(toy_recording, monkeypatch):
    import snarkos_tpu_torch.utils

    for name in READERS:
        assert _read(name, _ctx(traced=False)) is None
        assert _read(name, _ctx(requests=0)) is None
    with monkeypatch.context() as m:  # a program without the module
        m.setitem(sys.modules, "snarkos_tpu_torch.utils.tracing", None)
        m.delattr(snarkos_tpu_torch.utils, "tracing")
        assert all(_read(name, _ctx()) is None for name in READERS)
    assert _read("host_copies_per_batch", _ctx()) == 3.0
    monkeypatch.setattr(tracing, "_last", None)
    assert all(_read(name, _ctx()) is None for name in READERS)
