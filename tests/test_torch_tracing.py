"""The port's counters and spans (``snarkos_tpu_torch/utils/tracing.py``) on
the CPU: the null span with no profiler; a small ``prove_batch`` and a
``kzg.commit`` inside a CPU ``torch.profiler`` session, whose spans lie in
the chrome trace as ``layer:<phase>:<site>``, nested as the phases are, with
their records' parents and request ids; the benchmark's reduction naming
idle gaps by those phases; the copies counted by site and the session's
tally; the launch and engine counts as views of the one registry.

The leaves' sponge and the MSMs' group, scans and window tail run as cheap
stand-ins (the group's sums limb-wise, its one-call steps a copy or a
slice): the engine's control flow, and so its spans and copies, are those
of the card's path, at a fraction of the plain versions' cost.
``tracing.HOST`` is set to a device type no tensor has, so that the CPU
tensors' copies count as a card's would."""

import collections
import json
import os
import sys
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import trace as bench_trace
from snarkos_tpu_torch.ops import _build, g1, kzg, msm, msm_kernels, poseidon, puzzle
from snarkos_tpu_torch.ops.fieldspec import FQ, FR
from snarkos_tpu_torch.utils import native, tracing

torch.set_num_threads(1)

LOG_DEGREE = 2
EPOCH = b"\x03" * 32
NONCES = [5, 6]
WINDOWS = -(-(msm.SCALAR_BITS + 1) // msm.fused_window_bits(1 << LOG_DEGREE))


def _cheap_group(device):
    def identity(n):
        return tuple(torch.zeros((FQ.nlimbs, n), dtype=torch.int32, device=device)
                     for _ in range(3))

    def add(a, b):
        return tuple((x + y) & 0x7FFF for x, y in zip(a, b))

    def select(mask, a, b):
        return tuple(torch.where(mask.unsqueeze(0), x, y) for x, y in zip(a, b))

    def bucket_fixup(scan, keys, heads, summ, K, rows, nbatch, B):
        return identity(nbatch * B)

    return msm.GroupOps(identity=identity, add=add, select=select,
                        seg_prefix=lambda state: state, horner_chain=lambda ts, c: ts[0],
                        bucket_fixup=bucket_fixup)


def _cheap_scan(xs, ys, heads, K, chunk):
    return xs, ys, torch.ones_like(xs)


def _cheap_sponge(inputs, rate, domain="", num_outputs=1):
    return inputs[:num_outputs]


def _points(n):
    return g1.encode_points([(3 + i, 7 + i, 1) for i in range(n)], device="cpu")


def _profiled(tmp_path, fn):
    """``fn()`` as one request of the benchmark's traced run: inside a CPU
    profiler session and its request span, with a count before the session
    and one after it (which ends the recording). Returns the result, the
    recording, the chrome trace's events and the registry afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(msm, "g1_group", _cheap_group)
        mp.setattr(msm_kernels, "bucket_scan_serial", _cheap_scan)
        mp.setattr(poseidon, "hash_fixed", _cheap_sponge)
        mp.setattr(tracing, "HOST", "none")
        tracing.count("test.before_the_session")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(bench_trace.REQUEST_SPAN):
                out = fn()
        tracing.count("test.after_the_session")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    return types.SimpleNamespace(out=out, rec=tracing.recording(), events=events,
                                 counters=tracing.counters())


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    srs = puzzle.PuzzleSRS(degree=1 << LOG_DEGREE, points=_points((1 << LOG_DEGREE) + 1),
                           srs_ref=None)
    pz = puzzle.Puzzle(LOG_DEGREE, device="cpu", srs=srs)
    return _profiled(tmp_path_factory.mktemp("prove"),
                     lambda: pz.prove_batch(EPOCH, "aleo1tracing", NONCES))


@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    coeffs = torch.from_numpy(FR.encode_fast([1, 2, 3, 4], mont=True))
    return _profiled(tmp_path_factory.mktemp("commit"),
                     lambda: kzg.commit(_points(4), coeffs))


def _trace_spans(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(tracing.SPAN_PREFIX)]


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    monkeypatch.setattr(tracing, "_last", None)
    monkeypatch.setattr(tracing, "_COUNTS", {})
    span = tracing.span("prove.batch", "Puzzle.prove_batch")
    assert span is tracing.span("msm.scan", "_fused_msm_body")
    with span:
        tracing.count("launch.probe_kernel")
    assert tracing.recording() is None
    assert tracing.counters() == {"launch.probe_kernel": 1}


# the phase of each span's parent in prove_batch (None: the request's root)
PROVE_PARENTS = {
    "prove.batch": None, "prove.coefficients": "prove.batch", "msm.digits": "prove.batch",
    "msm.windows": "prove.batch", "msm.layout": "msm.windows", "msm.scan": "msm.windows",
    "msm.total": "msm.windows", "msm.horner": "prove.batch",
    "kzg.eval_quotient": "prove.batch", "sync.read": "prove.batch",
    "host.decode": "prove.batch", "host.challenge": "prove.batch", "host.ids": "prove.batch"}


def test_prove_batch_spans_nest_as_its_phases(proved):
    """Every span of prove_batch once a call as the table of phases says (3
    a window of each MSM), each inside its parent, all of one request and
    thread; the chrome trace holds the same spans under the same names."""
    spans = proved.rec.spans
    by_id = {s.id: s for s in spans}
    root, = [s for s in spans if s.phase == "prove.batch"]
    assert len(proved.out) == len(NONCES)
    assert collections.Counter(s.phase for s in spans) == {
        "prove.batch": 1, "prove.coefficients": 1, "msm.digits": 2, "msm.windows": 2,
        "msm.layout": 2 * WINDOWS, "msm.scan": 2 * WINDOWS, "msm.total": 2 * WINDOWS,
        "msm.horner": 2, "kzg.eval_quotient": 1, "sync.read": 3, "host.decode": 5,
        "host.challenge": 1, "host.ids": 1}
    for s in spans:
        assert s.request == root.id and s.thread == threading.get_ident()
        if s.parent is None:
            assert PROVE_PARENTS[s.phase] is None
            continue
        parent = by_id[s.parent]
        assert parent.phase == PROVE_PARENTS[s.phase]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert {(s.phase, s.site) for s in spans if s.phase == "sync.read"} == {
        ("sync.read", "decode_points"), ("sync.read", "kzg_y")}
    names = collections.Counter(e["name"] for e in _trace_spans(proved.events))
    assert names == collections.Counter(f"layer:{s.phase}:{s.site}" for s in spans)
    windows = [e for e in _trace_spans(proved.events)
               if e["name"].startswith("layer:msm.windows:")]
    for e in _trace_spans(proved.events):
        if e["name"].startswith(("layer:msm.layout:", "layer:msm.scan:", "layer:msm.total:")):
            assert any(w["ts"] <= e["ts"] and e["ts"] + e["dur"] <= w["ts"] + w["dur"]
                       for w in windows)


def test_commit_spans_and_reads(committed):
    """kzg.commit is its path's root: the z == 1 read, the MSM's phases and
    the exception read inside it."""
    spans = committed.rec.spans
    by_id = {s.id: s for s in spans}
    root, = [s for s in spans if s.phase == "kzg.commit"]
    assert root.parent is None and all(s.request == root.id for s in spans)
    reads = [s.site for s in spans if s.phase == "sync.read"]
    assert reads == ["msm_z_is_one", "msm_exception"]
    assert all(by_id[s.parent].phase == "kzg.commit" for s in spans
               if s.phase in ("sync.read", "msm.digits", "msm.windows", "msm.horner"))
    t = committed.rec.tally
    assert (t["copy.msm_z_is_one"], t["copy.msm_exception"]) == (1, 1)
    # from_mont's constant and msm.msm's one, each an upload on the card
    assert t["copy.broadcast_const"] == 2


def test_copies_are_counted_by_site(proved):
    """The session's tally holds the copies of the table's sites and none of
    the counts made before or after it: three reads a decode_points, two
    uploads of the points z and their inverses and one read of the ys;
    broadcast_const's uploads are the nonces' seeds, to_mont's and the two
    from_monts' constants and the two power tables' ones."""
    t = proved.rec.tally
    assert (t["copy.decode_points"], t["copy.kzg_encode"], t["copy.kzg_y"]) == (6, 2, 1)
    assert t["copy.broadcast_const"] == len(NONCES) + 5
    assert t["epoch_program.build"] == 1
    assert "test.before_the_session" not in t and "test.after_the_session" not in t
    assert proved.counters["test.before_the_session"] >= 1
    assert proved.rec.total("copy.") == 6 + 2 + 1 + len(NONCES) + 5


def test_the_benchmark_names_idle_gaps_by_phase(proved):
    """``benchmark.trace.reduce_trace`` of the traced prove, with device
    activity everywhere but one short gap inside a span of each phase: each
    gap is named by that phase."""
    phases = ["msm.digits", "msm.layout", "msm.scan", "msm.total", "msm.horner",
              "kzg.eval_quotient", "sync.read", "host.decode"]
    events = list(proved.events)
    req, = [e for e in events if e.get("name") == bench_trace.REQUEST_SPAN]
    first = {}
    for e in sorted(_trace_spans(events), key=lambda e: e["ts"]):
        first.setdefault(e["name"].split(":")[1], e)
    gaps = sorted((first[p]["ts"] + first[p]["dur"] / 2, (i + 1) * 1e-3)
                  for i, p in enumerate(phases))
    t, corr = req["ts"], 0
    for g0, length in gaps + [(req["ts"] + req["dur"], 0)]:
        events.append({"cat": "kernel", "ph": "X", "name": f"k{corr}", "ts": t, "dur": g0 - t,
                       "tid": 99, "args": {"correlation": corr}})
        t, corr = g0 + length, corr + 1
    summary = bench_trace.reduce_trace(events, {})
    named = [name.split(": ")[0] for name, _ in summary.idle_top]
    assert sorted(named) == sorted(phases)


def test_launch_and_engine_counts_are_views_of_the_registry(monkeypatch):
    monkeypatch.setattr(tracing, "_COUNTS", {})

    @_build.counted
    def probe_kernel():
        pass

    assert probe_kernel.launches == 0 and tracing.counters() == {"launch.probe_kernel": 0}
    assert _build.launch_counts() == {}
    for _ in range(3):
        _build.count(probe_kernel)
    assert probe_kernel.launches == 3 and _build.launch_counts() == {"probe_kernel": 3}
    native._count("g1_msm")
    native._count("g1_msm")
    assert native.call_counts() == {"g1_msm": 2}
    native.reset_counts()
    assert native.call_counts() == {} and _build.launch_counts() == {"probe_kernel": 3}


def test_a_rerun_is_counted(monkeypatch):
    """msm_affine reruns the complete engine after the fast one's exception
    flag, and counts it."""
    calls = []

    def fake(x, y, scalar_limbs, c, lanes, chunk, fast):
        calls.append(fast)
        return g1.infinity((1,), device="cpu"), torch.tensor(int(fast), dtype=torch.int32)

    monkeypatch.setattr(msm, "_msm_affine", fake)
    before = tracing.counters("msm.rerun").get("msm.rerun", 0)
    msm.msm_affine(*(torch.zeros((FQ.nlimbs, 4), dtype=torch.int32) for _ in range(2)),
                   torch.zeros((FR.nlimbs, 4), dtype=torch.int32))
    assert calls == [True, False]
    assert tracing.counters("msm.rerun")["msm.rerun"] == before + 1


def test_threads_lose_no_count_and_keep_their_own_spans(monkeypatch):
    """More threads than cores, a short switch interval, inside a profiler
    session: the registry and the session's tally each hold every count,
    and each span's parent and request are its own thread's."""
    monkeypatch.setattr(tracing, "_COUNTS", {})
    threads, n = 2 * (os.cpu_count() or 1) + 1, 300

    def work():
        for _ in range(n):
            with tracing.span("prove.batch", "work"):
                with tracing.span("host.ids", "work"):
                    tracing.count("launch.probe_kernel")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    tracing.count("test.after_the_session")
    rec = tracing.recording()
    assert tracing.counters()["launch.probe_kernel"] == rec.tally["launch.probe_kernel"] == (
        threads * n)
    by_id = {s.id: s for s in rec.spans}
    inner = [s for s in rec.spans if s.phase == "host.ids"]
    assert len(inner) == threads * n and rec.dropped == 0
    for s in inner:
        parent = by_id[s.parent]
        assert parent.phase == "prove.batch" and parent.thread == s.thread
        assert s.request == parent.id == parent.request
