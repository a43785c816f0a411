"""The traced run (``--trace 1``): spans around the calls into each layer,
the profiler's device trace, and what the per-layer metrics read from them.

A layer is a file ``benchmark/layers/<name>.py`` with ``LAYER`` (its name as
PERF.md's list of layers gives it), ``TARGETS`` (the functions of the
program that enter it, as ``module:attribute`` paths) and ``work(target,
arguments)``, the 32-bit multiplies and bytes that the algorithm needs for
the call's arguments (the numerator of the layer's roofline share). In a
traced run only, each target is replaced by a wrapper that opens a
``torch.profiler.record_function`` span named ``layer:<name>:<target>`` and
notes the call's work. A call into a layer from inside the same layer is
not wrapped again.

The device time of a span is that of the device activities (kernels,
copies, fills) whose launch the profiler correlates with a host call made
inside it: every span of the launching thread that holds the launch gets
it, so a layer's time includes that of the layers nested in it, and a layer
added inside another takes nothing from it. A kernel that is renamed,
merged or split stays in its layers.
"""

from __future__ import annotations

import bisect
import collections
import gc
import importlib
import inspect
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
REQUEST_SPAN = "bench.request"
SPAN_PREFIX = "layer:"
TOP = 10
TRACE_REQUESTS = 4  # the window's first requests that a traced run profiles


def resolve(path: str):
    """'pkg.module:Attr.attr' -> (owner object, attribute name)."""
    mod_name, _, attr = path.partition(":")
    owner = importlib.import_module(mod_name)
    *parents, name = attr.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, name


@dataclass
class LayerStats:
    calls: int = 0
    device_s: float = 0.0
    muls: float = 0.0
    nbytes: float = 0.0


@dataclass
class TraceSummary:
    requests: int
    window_s: float
    busy_s: float
    device_ops: int
    host_syncs: int
    unattributed_ops: int
    layers: dict = field(default_factory=dict)  # span name -> LayerStats
    device_top: list = field(default_factory=list)
    idle_top: list = field(default_factory=list)

    def layer(self, name: str, target: str | None = None) -> LayerStats | None:
        """The summed stats of layer ``name``'s spans (of one target, if
        given); None where no such span ran."""
        hits = [s for key, s in self.layers.items()
                if key.split(":", 2)[1] == name
                and (target is None or key.split(":", 2)[2] == target)]
        if not hits or not any(s.calls for s in hits):
            return None
        out = LayerStats()
        for s in hits:
            out.calls += s.calls
            out.device_s += s.device_s
            out.muls += s.muls
            out.nbytes += s.nbytes
        return out


class Tracer:
    """Wraps the layers' targets, profiles the first ``TRACE_REQUESTS``
    requests of the window, and reduces the trace to a ``TraceSummary``."""

    def __init__(self, layers: dict, device: str = "cuda"):
        self.layers = layers  # file name -> module
        self.cuda = device.startswith("cuda")
        self.work = collections.defaultdict(LayerStats)
        self.active = False
        self._open = set()  # the layers whose span the caller is inside
        self._saved = []
        self._prof = None
        self._summary = None

    # -- spans ---------------------------------------------------------------
    def install(self):
        from torch.profiler import record_function

        for name, layer in self.layers.items():
            for target in layer.TARGETS:
                owner, attr = resolve(target)
                orig = getattr(owner, attr)
                self._saved.append((owner, attr, orig))
                setattr(owner, attr, self._wrapper(name, layer, target, orig, record_function))

    def uninstall(self):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()

    def _wrapper(self, name, layer, target, orig, record_function):
        sig = inspect.signature(orig)
        span = f"{SPAN_PREFIX}{name}:{target}"

        def wrapper(*args, **kwargs):
            if not self.active or name in self._open:
                return orig(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            muls, nbytes = layer.work(target, bound.arguments)
            stats = self.work[span]
            stats.calls += 1
            stats.muls += muls
            stats.nbytes += nbytes
            self._open.add(name)
            try:
                with record_function(span):
                    return orig(*args, **kwargs)
            finally:
                self._open.discard(name)

        wrapper.__wrapped__ = orig
        return wrapper

    # -- the profiled requests -------------------------------------------------
    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])

    def _sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def warm(self):
        """One short profiler session, so that the profiler's own start-up
        falls in the set-up and not in the traced requests."""
        import torch
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.zeros(1, device="cuda" if self.cuda else "cpu").add_(1)
            self._sync()

    def wrap_call(self, call):
        from torch.profiler import profile, record_function

        def traced(i):
            if i >= TRACE_REQUESTS:
                return call(i)
            if i == 0:
                self._sync()
                self._prof = profile(activities=self._activities())
                self._prof.__enter__()
                self.active = True
            try:
                with record_function(REQUEST_SPAN):
                    return call(i)
            finally:
                if i == TRACE_REQUESTS - 1:
                    self.stop()

        return traced

    def stop(self):
        """End the profiled part (after the last traced request, or when the
        window closed before it)."""
        if self._prof is None or not self.active:
            return
        self._sync()
        self.active = False
        self._prof.__exit__(None, None, None)

    def summary(self) -> TraceSummary | None:
        if self._summary is None and self._prof is not None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as fh:
                    events = json.load(fh)
            self._prof = None
            events = events["traceEvents"] if isinstance(events, dict) else events
            self._summary = reduce_trace(events, self.work)
            del events
            gc.collect()
        return self._summary


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list, work: dict) -> TraceSummary:
    """Reduce a chrome trace's events (times in microseconds) to the
    summary: the window runs from the first traced request's start to the
    last one's end; device activities and host syncs are counted inside it."""
    requests = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == REQUEST_SPAN]
    if not requests:
        return TraceSummary(0, 0.0, 0.0, 0, 0, 0)
    w0 = min(e["ts"] for e in requests)
    w1 = max(e["ts"] + e.get("dur", 0) for e in requests)

    def inside(e):
        return w0 <= e["ts"] <= w1

    device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
              and inside(e)]
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
    syncs = sum(1 for e in events if e.get("cat") in LAUNCH_CATS and inside(e)
                and "Synchronize" in e.get("name", ""))

    # the layer spans of each host thread, by start
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
            spans[e.get("tid")].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    starts = {}
    for tid, lst in spans.items():
        lst.sort()
        starts[tid] = [s for s, _, _ in lst]

    def enclosing(tid, ts):
        """The names of the spans of thread ``tid`` that hold moment ``ts``."""
        lst = spans.get(tid, ())
        k = bisect.bisect_right(starts.get(tid, ()), ts)
        return {name for s, e, name in lst[:k] if s <= ts <= e}

    stats = {name: LayerStats(s.calls, 0.0, s.muls, s.nbytes) for name, s in work.items()}
    unattributed = 0
    by_name = collections.Counter()
    for e in device:
        dur = e.get("dur", 0) * 1e-6
        by_name[e.get("name", "?")] += dur
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            unattributed += 1
            continue
        for span in enclosing(launch.get("tid"), launch["ts"]):
            stats.setdefault(span, LayerStats()).device_s += dur

    busy = _union((max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)) for e in device)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    idle = _idle_by_host(events, busy, w0, w1)
    return TraceSummary(
        requests=len(requests), window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
        device_ops=len(device), host_syncs=syncs, unattributed_ops=unattributed,
        layers=stats,
        device_top=[[n[:160], s] for n, s in by_name.most_common(TOP)],
        idle_top=idle)


def _idle_by_host(events, busy, w0, w1) -> list:
    """The device's idle gaps inside the window, summed by what the host was
    doing when each began: the innermost host event of the requests' thread
    that held that moment (an operator, a runtime call), named with the
    innermost layer span that held it, if any."""
    req_tid = next(e.get("tid") for e in events if e.get("name") == REQUEST_SPAN)
    host = sorted(((e["ts"], -(e["ts"] + e.get("dur", 0)), e.get("name", "?"))
                   for e in events
                   if e.get("tid") == req_tid and e.get("ph") == "X"
                   and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                        "cuda_driver")))
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    total = collections.Counter()
    stack, j = [], 0  # host events that hold the sweep's moment, innermost last
    for g0, g1 in gaps:
        while j < len(host) and host[j][0] <= g0:
            s, neg_end, name = host[j]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((-neg_end, name))
            j += 1
        while stack and stack[-1][0] <= g0:
            stack.pop()
        live = [name for end, name in stack if end > g0]
        layer = next((n.split(":", 2)[1] for n in reversed(live) if n.startswith(SPAN_PREFIX)),
                     None)
        inner = next((n for n in reversed(live)
                      if not n.startswith(SPAN_PREFIX) and n != REQUEST_SPAN), None)
        what = inner[:120] if inner else "python between operations"
        if layer:
            what = f"{layer}: {what}"
        total[what] += (g1 - g0) * 1e-6
    return [[n, s] for n, s in total.most_common(TOP)]
