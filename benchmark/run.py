"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the program, ``snarkos_tpu_torch/``, on a machine with the cards the
cell asks for. Prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each number held to its limit; the
same numbers are the last lines of standard error. Exits 2 without the
cards, 3 if the process holds JAX or the JAX package once the window has
closed; no result line then.

Build outputs stay inside the checkout at fixed paths: the program's kernels
and host engines in ``build/kernels`` and ``build/host``, the cache
directories of the toolchains under ``build/cache``, and the bytecode of
every Python module the run imports (PyTorch's included) under
``build/cache/pycache``, so that only a checkout's first run compiles it.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "nv_compute"}
# the program reads these; the benchmark's cells run the dev SRS and the
# log degree their configuration gives
UNSET = ("SNARKOS_TPU_SRS_PATH", "SNARKOS_TPU_SRS_DIGEST", "SNARKOS_TPU_PUZZLE_LOG_DEGREE")


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _diagnostics(res: dict) -> None:
    """Where the set-up went (seconds from the start of the process at the
    end of each phase), the spread of the window's requests, and the time
    the comparison took, on standard error."""
    w = res["window"]
    lat = sorted(r.latency for r in w.done)
    phases = ", ".join(f"{k} {v:.2f}" for k, v in res["setup_phases"].items())
    print(f"set-up (s from the start): {phases}", file=sys.stderr)
    if lat:
        print(f"window: {len(lat)} requests in {w.seconds:.3f} s; latency min "
              f"{lat[0] * 1e3:.2f} median {lat[len(lat) // 2] * 1e3:.2f} max {lat[-1] * 1e3:.2f} "
              f"ms; first {[round(r.latency * 1e3, 2) for r in w.done[:3]]}", file=sys.stderr)
    print(f"comparison with the reference: {res['check_s']:.2f} s", file=sys.stderr)


def prepare() -> None:
    """The run's environment: the toolchains' caches and the bytecode cache
    at fixed paths inside the checkout (written even where the environment
    says not to write bytecode), none of the program's SRS settings, the
    checkout first on the import path."""
    sys.pycache_prefix = os.path.join(ROOT, "build", "cache", "pycache")
    sys.dont_write_bytecode = False
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "cache", sub)
    for var in UNSET:
        os.environ.pop(var, None)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    prepare()

    import torch

    from benchmark import harness

    bench = harness.Benchmark(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    summary = res["trace"]
    if summary is not None:
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        line["breakdown"] = {"device_ops": summary.device_top, "idle_gaps": summary.idle_top}
        print(f"trace: {summary.requests} requests, {summary.device_ops} device ops, "
              f"{summary.unattributed_ops} without a launch record, {summary.host_syncs} "
              f"host syncs", file=sys.stderr)
    device["power_limit"] = _power_limit()
    _diagnostics(res)
    line["compared"] = res["compared"]
    for err in res["errors"]:
        print(f"failed request: {err}", file=sys.stderr)
    for name, c in res["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
