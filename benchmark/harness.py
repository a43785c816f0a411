"""The harness: finds a cell's configuration, traffic mix, driver, layers and
metric readers by the names in ``BENCHMARK.json``, runs one measured window
and judges its outputs.

Everything that belongs to one item is a file of its own under
``benchmark/``, found by name, so that a later change adds an item by
adding files:

    configs/<config>.json    the configuration; names its driver and holds
                             the sizes as run (``BENCHMARK.json`` gives the
                             file)
    drivers/<driver>.py      builds the system under test from the program,
                             makes a seed's inputs, sends request i, and
                             judges the outputs against the plain reference
                             (``reference/``)
    traffic/<traffic>.json   the mix's parameters, read by the driver
    layers/<layer>.py        a layer's span targets and its work count
                             (``trace``)
    metrics/<metric>.py      ``read(ctx)``: a metric's value, or None where
                             this cell has nothing to read
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import sys
import time
from dataclasses import dataclass

from benchmark import loadgen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "snarkos_tpu")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_file(kind: str, name: str, here: str = HERE):
    """The module ``<here>/<kind>/<name>.py``, loaded by its path (a name may
    hold dots and dashes)."""
    path = os.path.join(here, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    mod_name = f"benchmark.{kind}.{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Benchmark:
    """``BENCHMARK.json`` at ``root`` and the files under ``here``."""

    def __init__(self, root: str = ROOT, here: str = HERE):
        self.root, self.here = root, here
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.here, "traffic", f"{name}.json"))

    def metrics(self, workload: str, trace: bool) -> list:
        """The metrics a run of ``workload`` reports: its end-to-end ones, or
        with ``trace`` its per-layer ones. A metric without a ``workloads``
        list belongs to every cell (an end-to-end one), or to every cell that
        reports the end-to-end metric it moves (a per-layer one)."""
        e2e = [m for m in self.spec["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]

    def layers(self) -> dict:
        d = os.path.join(self.here, "layers")
        return {f[:-3]: load_file("layers", f[:-3], self.here)
                for f in sorted(os.listdir(d)) if f.endswith(".py")}


@dataclass
class Context:
    """What a metric reader reads."""

    workload: str
    window: loadgen.Window
    setup_s: float
    units: int  # work units (nonces, points) a request
    trace: object = None  # trace.TraceSummary, in a traced run

    @property
    def requests(self) -> int:
        return len(self.window.done)

    def rate(self) -> float:
        return self.requests * self.units / self.window.seconds


def sample(items: list, k: int, seed: int) -> list:
    """k of the items (all, if fewer), drawn from the seed, in their order."""
    rng = random.Random(f"check:{seed}")
    return [items[i] for i in sorted(rng.sample(range(len(items)), min(k, len(items))))]


def run_cell(bench: Benchmark, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, patch=None, build=None) -> dict:
    """One run of a cell: set-up (build, inputs, warm-up), the window, the
    reading of memory and trace, then the comparison with the reference.
    ``patch(cell)``, where given, replaces part of the timed path before the
    window, and ``build(config, device)`` the driver's build of the system
    (the control and the fault tests). Returns the result's fields."""
    wl = bench.workload(workload)
    config = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    driver = load_file("drivers", config["driver"], bench.here)
    metrics = bench.metrics(workload, trace)
    phases = {"imports": time.monotonic() - t_start}
    system = (build or driver.build)(config, device)
    phases["build"] = time.monotonic() - t_start
    cell = driver.Cell(system, config, traffic, seed)
    phases["inputs"] = time.monotonic() - t_start
    cell.warm()
    phases["warm"] = time.monotonic() - t_start
    if patch is not None:
        patch(cell)
    call, tracer = cell.call, None
    if trace:
        from benchmark import trace as trace_mod

        tracer = trace_mod.Tracer(bench.layers(), device)
        tracer.warm()
        tracer.install()
        call = tracer.wrap_call(cell.call)
    _sync(cell.device)
    setup_s = time.monotonic() - t_start
    try:
        window = loadgen.run(call, seconds)
    finally:
        if tracer is not None:
            tracer.stop()
            tracer.uninstall()
    out = {"memory_peak_bytes": _memory_peak(cell.device), "setup_phases": phases}
    summary = tracer.summary() if tracer is not None else None
    ctx = Context(workload, window, setup_s, cell.units, summary)
    values = {}
    for m in metrics:
        v = load_file("metrics", m["name"], bench.here).read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    t_check = time.monotonic()
    compared = cell.check(window, seed)
    out["check_s"] = time.monotonic() - t_check
    failed = len(window.failed)
    out.update(
        correct=bool(window.done) and failed == 0
        and all(c["value"] <= c["limit"] for c in compared.values()),
        attempted=len(window.records), failed=failed, metrics=values,
        compared=compared, trace=summary, window=window,
        errors=[r.error for r in window.failed][:3])
    return out


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _memory_peak(device) -> int:
    """The process's peak of allocated device memory (0 on the CPU)."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
