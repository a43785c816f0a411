"""The staging and occupancy constants of ``g1_lane_buckets``
(``csrc/lane_scan.cu``), swept on the card.

    python3 scripts/sweep_lane_buckets.py [--reps 5]

Builds copies of ``csrc/lane_scan.cu`` into ``build/lane_sweep/`` (one nvcc
each, all started together, with the package's flags), each with one or two
of its constants changed: kTile (positions a member stages at a time) and
kMaxThreads (the kernel's launch bound: 384 caps registers at 168, room for
more warps an SM where shared memory allows). For each build it reports ptxas's registers,
stack and spills and the local loads and stores (LDL, STL) of
``lane_buckets_kernel`` in its machine code (``cuobjdump -sass``).

Then it runs every build on one window of the generic engine at each of m =
16 (2^16 points), 256 (2^20) and 4096 (2^24) positions a lane: K = 4096
lanes, B = 2^13 buckets, sorted random keys, 1024 distinct points drawn at
random, every 1000th the identity, with the plan ``msm_kernels.lane_plan(m)``
gives. Every output is held limb for limb to the committed build's (the
constants change no add) and timed (CUDA events around one launch, median of
``--reps`` after a warm-up). Prints a line per build and shape and, last, one
JSON line with the card's name and power limit, also written to
``chiprun_out/lane_sweep.json``. Needs nvcc and a CUDA device.
"""

import argparse
import ctypes
import json
import os
import random
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# name: the constants changed from the committed source's
VARIANTS = {
    "committed": {},
    "kTile=1": {"kTile": 1},
    "kTile=4": {"kTile": 4},
    "kTile=8": {"kTile": 8},
    "kMaxThreads=384": {"kMaxThreads": 384},
    "kTile=1 kMaxThreads=384": {"kTile": 1, "kMaxThreads": 384},
}
SHAPES = ((16, 16), (256, 20), (4096, 24))  # (m, log2 n)
K = 4096
LOG_B = 13


def patched(src: str, consts: dict) -> str:
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"lane_scan.cu: no single definition of {name}")
    return src


def build_all(_build, out_dir):
    """{variant: (library path, ptxas lines)}, one nvcc a variant at once."""
    with open(os.path.join(_build.CSRC, "lane_scan.cu")) as fh:
        src = fh.read()
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for v, consts in VARIANTS.items():
        tag = re.sub(r"\W+", "_", v)
        cu = os.path.join(out_dir, f"lane_scan_{tag}.cu")
        with open(cu, "w") as fh:
            fh.write(patched(src, consts))
        lib = os.path.join(out_dir, f"liblane_scan_{tag}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib, cu]
        jobs[v] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True))
    built = {}
    for v, (lib, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{text}")
        built[v] = (lib, text.splitlines())
    return built


def ptxas_report(lines):
    """The registers, stack and spill stores ptxas reports for
    lane_buckets_kernel: from its 'Compiling entry function' line to the
    next one, its 'Used N registers' and the line after its 'Function
    properties'."""
    out, inside, props = {}, False, False
    for ln in lines:
        if "Compiling entry function" in ln:
            inside = "lane_buckets_kernel" in ln
        elif inside and "Function properties for" in ln:
            props = "lane_buckets_kernel" in ln
        elif inside and props and "bytes stack frame" in ln:
            out["stack"] = int(re.search(r"(\d+) bytes stack frame", ln).group(1))
            out["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
            props = False
        elif inside and "Used" in ln and "registers" in ln:
            out["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_lane_buckets: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    from compare_add_sass import sass_stats

    from snarkos_tpu_torch.crypto import params
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1
    from snarkos_tpu_torch.ops import _build, g1, msm_kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    built = build_all(_build, os.path.join(ROOT, "build", "lane_sweep"))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    report = {"card": card, "K": K, "B": 1 << LOG_B, "variants": {}}
    fns = {}
    for v, (lib, ptxas) in built.items():
        sass = sass_stats(subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                                         text=True, check=True).stdout)
        local = {f: (s.get("LDL", 0), s.get("STL", 0)) for f, s in sass.items()
                 if "lane_buckets_kernel" in f}
        fn = getattr(ctypes.CDLL(lib), "g1_lane_buckets")
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[v] = fn
        rep = {"consts": VARIANTS[v], **ptxas_report(ptxas),
               "LDL_STL": list(next(iter(local.values()), (None, None))), "ms": {}}
        report["variants"][v] = rep
        print(f"{v}: registers {rep.get('registers')}, stack {rep.get('stack')} B, spill stores "
              f"{rep.get('spill_stores')} B, LDL / STL {rep['LDL_STL']}", flush=True)

    dev = torch.device("cuda")
    prng = random.Random(14)
    h = ref_g1.scalar_mul(prng.randrange(1, params.FR_MODULUS), ref_g1.GENERATOR)
    pool, acc = [], h
    for _ in range(1024):
        pool.append(acc)
        acc = ref_g1.add(acc, h)
    base = g1.encode_points(pool, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    B = 1 << LOG_B
    for m, log_n in SHAPES:
        n = 1 << log_n
        keys = torch.sort(torch.randint(0, B, (n,), generator=gen, device=dev)).values
        idx = torch.randint(0, 1024, (n,), generator=gen, device=dev)
        x, y, z = (t[:, idx].contiguous() for t in (base.x, base.y, base.z))
        z[:, ::1000] = 0
        M, MB = msm_kernels.lane_plan(m)

        def outputs():
            return ([torch.empty((24, B), dtype=torch.int32, device=dev) for _ in range(3)]
                    + [torch.empty((1, K), dtype=torch.int32, device=dev)]
                    + [torch.empty((24, K), dtype=torch.int32, device=dev) for _ in range(3)]
                    + [torch.empty(K, dtype=torch.int32, device=dev) for _ in range(2)])

        def run(fn, outs):
            _build.launch(fn, (keys, x, y, z, *outs), (n, K, B, M, MB), dev)
            return outs

        want = run(fns["committed"], outputs())
        for v, fn in fns.items():
            got = run(fn, outputs())
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{v} at m = {m}: its outputs differ from the committed "
                                     "build's")
            times = []
            for _ in range(args.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(fn, got)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            times.sort()
            ms = times[len(times) // 2]
            report["variants"][v]["ms"][f"m={m}"] = ms
            print(f"{v} m = {m} (2^{log_n}, plan {(M, MB)}): {ms:.4f} ms, outputs equal to the "
                  f"committed build's on {card}", flush=True)
        del keys, idx, x, y, z, want
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    line = json.dumps(report)
    with open(os.path.join(ROOT, "chiprun_out", "lane_sweep.json"), "w") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
