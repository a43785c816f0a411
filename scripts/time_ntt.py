"""Host-clock times of the NTT's small sizes in one checkout, where the
host's launches set the time.

    python3 scripts/time_ntt.py [--root DIR] [--reps 21]

Builds the checkout at DIR (this one by default) and prints one JSON line
with the card's name and power limit and, for ntt at 2^12 and 2^16: the
median host time of one call (``--reps`` calls, each ending in a device
sync, after a warm-up), the device time of one call (a CUDA graph of 20
calls, median of 5 replays) and the launches a call; and the host time of
one ``_build.entry`` lookup (median of 5 runs of 10,000). To compare two
checkouts, run it on both in turns on one card (old, new, new, old).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=21)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ntt: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np

    from snarkos_tpu_torch.ops import _build, ntt
    from snarkos_tpu_torch.ops.fieldspec import FR

    _build.build(("mont_mul", "ntt"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    out = {"root": root, "card": smi}
    counters = [f for f in vars(ntt).values() if callable(f) and hasattr(f, "launches")]
    for log_n in (12, 16):
        a = torch.from_numpy(FR.random(1 << log_n, np.random.default_rng(log_n))).to(dev)
        ntt.ntt(a)
        torch.cuda.synchronize()
        host = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            ntt.ntt(a)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        for f in counters:
            f.launches = 0
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                ntt.ntt(a)
        launches = sum(f.launches for f in counters) // 20
        graph.replay()
        torch.cuda.synchronize()
        device = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            device.append(start.elapsed_time(end) / 20)
        out[f"ntt_2^{log_n}"] = {"host_ms": statistics.median(host),
                                 "device_ms": statistics.median(device), "launches": launches}
    _build.entry("mont_mul", "mont_mul_fr", 3, 1)
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(10_000):
            _build.entry("mont_mul", "mont_mul_fr", 3, 1)
        runs.append((time.perf_counter() - t0) / 10_000 * 1e6)
    out["entry_lookup_us"] = statistics.median(runs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
