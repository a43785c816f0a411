"""The latency of the MSM's window tail on the card: the Horner step's
doublings and add, and the local-memory traffic of the kernels that run it.

    python3 scripts/time_window_tail.py [--root DIR]

Builds the checkout at DIR (this one by default) and times, on random
finite points (CUDA-graph replays of 20 launches, median of 7):
- where the checkout has ``g1_kernels.horner_kernel`` (one launch a
  window, acc = 2^c acc + t): that entry at widths 1, 8 and 32 for c = 0,
  1, 2, 4, 8, 14, and ``g1_add`` at the same widths;
- where it has ``g1_kernels.horner_chain_kernel`` (one launch a MSM, the
  whole chain over W windows from the identity): the chain at W = 8
  windows and widths 1, 8 and 32 for the same c;
and fits ms = a + b c at each width (least squares). For the one-step
entry b is one doubling's latency and a one add plus the launch; for the
chain b / (W - 1) is a doubling (the top window's acc is the identity and
is not doubled) and a / W about one add.

It also dumps the machine code of the sources that hold those entries
(``cuobjdump -sass``) into ``chiprun_out/window_tail/`` and counts, per
function, instructions and local loads and stores (LDL, STL), beside
ptxas's registers and spills. Prints one JSON line with the card's name and
power limit. Needs nvcc and a CUDA device.
"""

import argparse
import json
import os
import random
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CS = (0, 1, 2, 4, 8, 14)
WIDTHS = (1, 8, 32)
CHAIN_W = 8


def fit(cs, ms):
    """Least-squares (a, b) of ms = a + b c."""
    n = len(cs)
    mc, mm = sum(cs) / n, sum(ms) / n
    b = sum((c - mc) * (m - mm) for c, m in zip(cs, ms)) / sum((c - mc) ** 2 for c in cs)
    return mm - b * mc, b


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_window_tail: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from compare_add_sass import sass_stats

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from snarkos_tpu_torch.crypto import params
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1
    from snarkos_tpu_torch.ops import _build, g1, g1_kernels

    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    prng = random.Random(13)
    h = ref_g1.scalar_mul(prng.randrange(1, params.FR_MODULUS), ref_g1.GENERATOR)
    pool, acc = [], h
    for _ in range(64):
        pool.append(acc)
        acc = ref_g1.add(acc, h)

    def points(n):
        return g1.encode_points([pool[prng.randrange(len(pool))] for _ in range(n)], dev)

    def graph_ms(fn, reps=7, inner=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / inner)
        times.sort()
        return times[len(times) // 2]

    out = {"root": root, "card": smi, "cs": list(CS)}
    chain = hasattr(g1_kernels, "horner_chain_kernel")
    out["entry"] = "horner_chain" if chain else "horner"
    sweeps = {}
    for width in WIDTHS:
        if chain:
            ts = [points(width) for _ in range(CHAIN_W)]
            stack = tuple(torch.stack([getattr(p, k) for p in ts]).contiguous() for k in "xyz")
            ms = [graph_ms(lambda c=c: g1_kernels.horner_chain_kernel(stack, c)) for c in CS]
        else:
            a, t = points(width), points(width)
            ms = [graph_ms(lambda c=c: g1_kernels.horner_kernel(a, t, c)) for c in CS]
            sweeps[f"g1_add w{width}"] = graph_ms(lambda: g1_kernels.add_kernel(a, t))
        a0, b0 = fit(CS, ms)
        sweeps[f"w{width}"] = {"ms": ms, "a_ms": a0, "b_ms": b0}
        print(f"{out['entry']} width {width}: ms {[round(v, 4) for v in ms]} at c = {list(CS)}; "
              f"fit a = {a0:.4f} ms, b = {b0:.5f} ms a c on {smi}", flush=True)
    out["sweeps"] = sweeps

    dump = os.path.join(ROOT, "chiprun_out", "window_tail")
    os.makedirs(dump, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = {}
    for name in ("g1_add", "window_tail"):
        if name not in _build.SOURCES:
            continue
        text = subprocess.run([cuobjdump, "-sass", _build.lib_path(name)], capture_output=True,
                              text=True, check=True).stdout
        tag = f"{name}-{'chain' if chain else 'step'}"
        with open(os.path.join(dump, f"{tag}.sass.txt"), "w") as fh:
            fh.write(text)
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "stack" in ln or "spill" in ln or "Compiling" in ln]
        sass[name] = {"functions": sass_stats(text), "ptxas": ptxas}
        for fn, st in sass[name]["functions"].items():
            print(f"  {name} {fn}: {st}", flush=True)
        for ln in ptxas:
            print(f"  {name} ptxas: {ln}", flush=True)
    out["sass"] = sass
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
