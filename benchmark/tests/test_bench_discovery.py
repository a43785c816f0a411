"""The harness finds a new configuration, traffic mix, driver, layer and
metric reader added as files (and entries of BENCHMARK.json) in a copy of
the benchmark, without an edit to any file under benchmark/, and runs the
new cell untraced and traced. A layer added inside another takes nothing
from it."""

from __future__ import annotations

import hashlib
import json
import os
import time

import pytest
from bench_support import bench_copy

from benchmark import harness, trace

TOY_DRIVER = '''
"""A toy system: request i sums the squares of a seeded tensor's row i."""
import torch


def square(t):
    return t.long() * t.long()


def square_sum(t):
    return int(square(t).sum())


def build(config, device):
    return {"device": torch.device(device)}


class Cell:
    def __init__(self, system, config, traffic, seed):
        g = torch.Generator().manual_seed(seed)
        self.rows = torch.randint(0, 1000, (traffic["rows"], config["width"]), generator=g)
        self.units = config["width"]
        self.device = system["device"]

    def call(self, i):
        return square_sum(self.rows[i % len(self.rows)])

    def warm(self):
        self.call(0)

    def check(self, window, seed):
        wrong = sum(1 for r in window.done
                    if r.output != sum(int(v) ** 2 for v in self.rows[r.index % len(self.rows)]))
        return {"mismatched": {"value": wrong, "limit": 0, "sampled": len(window.done)}}
'''

TOY_LAYER = '''
LAYER = "toy squares"
TARGETS = ["benchmark.drivers.toy:square_sum"]


def work(target, args):
    return args["t"].numel(), 8 * args["t"].numel()
'''

TOY_INNER_LAYER = '''
LAYER = "toy squares, inner"
TARGETS = ["benchmark.drivers.toy:square"]


def work(target, args):
    return args["t"].numel(), 0
'''

TOY_RATE = '''
def read(ctx):
    return ctx.rate() if ctx.window.done else None
'''

TOY_CALLS = '''
def read(ctx):
    st = ctx.trace.layer("toy") if ctx.trace else None
    return st.calls / ctx.trace.requests if st else None
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _toy_copy(tmp_path, layers=("toy",)):
    """A copy of the benchmark with the toy configuration, driver, traffic
    mix, metrics and cell added, and the toy layers named."""
    root = bench_copy(tmp_path)
    texts = {"toy": TOY_LAYER, "toy_inner": TOY_INNER_LAYER}
    files = {"benchmark/configs/toy.json": json.dumps({"driver": "toy", "width": 64}),
             "benchmark/drivers/toy.py": TOY_DRIVER,
             "benchmark/traffic/toy-closed.json": json.dumps({"rows": 5}),
             "benchmark/metrics/toy_rate.py": TOY_RATE,
             "benchmark/metrics/toy_calls.py": TOY_CALLS}
    files.update({f"benchmark/layers/{n}.py": texts[n] for n in layers})
    _add(root, files)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "toy", "source": "a test", "file": "benchmark/configs/toy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy-cell", "config": "toy", "traffic": "toy-closed",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "toy_rate", "unit": "values/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": ["toy-cell"]})
    spec["per_layer"].append({"name": "toy_calls", "unit": "calls", "better": "lower",
                              "source": "program_span", "layer": "toy squares",
                              "moves": "toy_rate", "workloads": ["toy-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return root


def _add(root, files):
    for rel, text in files.items():
        with open(os.path.join(root, rel), "w") as fh:
            fh.write(text)


def test_new_items_are_found_by_name(tmp_path):
    before = _digests(bench_copy(tmp_path / "plain"))
    root = _toy_copy(tmp_path)

    bench = harness.Benchmark(root, os.path.join(root, "benchmark"))
    plain = harness.run_cell(bench, "toy-cell", 7, 0.2, False, "cpu", time.monotonic())
    assert plain["correct"] and plain["attempted"] > 3
    assert set(plain["metrics"]) == {"toy_rate", "setup_s"}
    assert plain["metrics"]["toy_rate"]["value"] > 0
    traced = harness.run_cell(bench, "toy-cell", 7, 0.2, True, "cpu", time.monotonic())
    assert traced["correct"]
    assert traced["metrics"] == {"toy_calls": {"value": 1.0, "unit": "calls"}}
    assert traced["trace"].layer("toy").muls == trace.TRACE_REQUESTS * 64
    # the files that were there are as they were
    after = _digests(root)
    assert {k: after[k] for k in before} == before
    # the new cell is no other cell's: the benchmark's own cells do not list it
    assert "toy_calls" not in [m["name"] for m in bench.metrics("prover-b8", True)]


def test_a_nested_layer_takes_nothing_from_its_parent(tmp_path):
    """A layer whose target the toy layer calls: the toy layer's calls and
    work stay as they were, and the new one counts its own."""
    runs = []
    for layers in (("toy",), ("toy", "toy_inner")):
        root = _toy_copy(tmp_path / "_".join(layers), layers)
        bench = harness.Benchmark(root, os.path.join(root, "benchmark"))
        runs.append(harness.run_cell(bench, "toy-cell", 7, 0.2, True, "cpu",
                                     time.monotonic())["trace"])
    before, after = runs
    assert before.layer("toy_inner") is None
    assert (after.layer("toy").calls, after.layer("toy").muls) == (
        before.layer("toy").calls, before.layer("toy").muls)
    assert after.layer("toy_inner").calls == after.layer("toy").calls == trace.TRACE_REQUESTS


def _events(inner: bool) -> list:
    """A chrome trace of one request: an outer layer span holding three
    kernels' launches, the first inside an inner layer span (where given),
    and a fourth kernel launched outside both."""
    ev = [{"cat": "user_annotation", "ph": "X", "name": trace.REQUEST_SPAN, "ts": 0,
           "dur": 100, "tid": 1},
          {"cat": "user_annotation", "ph": "X", "name": "layer:msm:T", "ts": 10, "dur": 50,
           "tid": 1}]
    if inner:
        ev.append({"cat": "user_annotation", "ph": "X", "name": "layer:phase:U", "ts": 20,
                   "dur": 10, "tid": 1})
    for corr, (launch, start, dur) in enumerate([(25, 30, 5), (40, 45, 7), (50, 55, 2),
                                                 (70, 75, 3)]):
        ev.append({"cat": "cuda_runtime", "ph": "X", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 1, "tid": 1, "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "ph": "X", "name": f"k{corr}", "ts": start, "dur": dur,
                   "tid": 7, "args": {"correlation": corr}})
    return ev


def test_device_time_goes_to_every_enclosing_layer():
    work = {"layer:msm:T": trace.LayerStats(1, 0.0, 10.0, 0.0),
            "layer:phase:U": trace.LayerStats(1, 0.0, 1.0, 0.0)}
    alone = trace.reduce_trace(_events(False), {"layer:msm:T": work["layer:msm:T"]})
    nested = trace.reduce_trace(_events(True), work)
    assert alone.layer("msm").device_s == pytest.approx(14e-6)
    assert nested.layer("msm").device_s == alone.layer("msm").device_s
    assert nested.layer("phase").device_s == pytest.approx(5e-6)
    assert nested.busy_s == pytest.approx(17e-6) and nested.device_ops == 4
