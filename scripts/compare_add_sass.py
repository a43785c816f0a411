"""Machine code of kernel B7 built with two complete G1 additions, and one
run of each build on the card.

    python3 scripts/compare_add_sass.py [--old SRC]

The two additions: the select form of ``csrc/g1.cuh`` (the one every kernel
uses: the generic formula always, then the doubling and the special cases
patched in) and a branch-first form (an identity operand returns at once,
P == Q doubles and returns, and only the rest runs the generic formula; the
same limbs). The branch-first form lives only here: it is patched into a
copy of the headers.

Builds ``csrc/jadd_scan.cu`` (and, with ``--old``, another source whose C
entry is ``jadd_scan(xs, ys, zs, ox, oy, oz, m, K, chunk, stream)``, the
per-chain scan of earlier versions) once with each addition into
``build/add_sass/``, with the package's nvcc flags; dumps each build's
machine code (``cuobjdump -sass``) and ptxas's report into
``chiprun_out/add_sass/``; prints per function the instructions, local
loads and stores (LDL, STL), calls and returns. Then runs each build once:
``jadd_bucket_total`` at B = 2^13 + 1 (dev SRS powers, identities at every
16th bucket), held against ``bucket_total_plain`` with g1.same_points;
timed over 20 launches (CUDA events); the old entry at (24, 72, 128), chunk
8, the two builds compared limb for limb. A build whose launch fails prints
its CUDA error. Needs nvcc and a CUDA device.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

SELECT_ADD_START = "__device__ __forceinline__ void g1_add(Jac& o, const Jac& p, const Jac& q) {"
BRANCH_FIRST_ADD = """__device__ __forceinline__ void g1_add(Jac& o, const Jac& p, const Jac& q) {
    if (is_zero<Fq>(p.z)) {
        o = q;
        return;
    }
    if (is_zero<Fq>(q.z)) {
        o = p;
        return;
    }
    uint32_t z1z1[12], z2z2[12], u1[12], u2[12], s1[12], s2[12];
    uint32_t h[12], rr[12], i[12], j[12], v[12], t[12];
    sqr<Fq>(z1z1, p.z);
    sqr<Fq>(z2z2, q.z);
    mont_mul<Fq>(u1, p.x, z2z2);
    mont_mul<Fq>(u2, q.x, z1z1);
    mont_mul<Fq>(t, p.y, q.z);
    mont_mul<Fq>(s1, t, z2z2);
    mont_mul<Fq>(t, q.y, p.z);
    mont_mul<Fq>(s2, t, z1z1);
    const bool x_eq = eq<Fq>(u1, u2);
    if (x_eq && eq<Fq>(s1, s2)) {
        g1_double(o, p);
        return;
    }
    sub<Fq>(h, u2, u1);
    sub<Fq>(rr, s2, s1);
    dbl<Fq>(rr, rr);
    dbl<Fq>(t, h);
    sqr<Fq>(i, t);
    mont_mul<Fq>(j, h, i);
    mont_mul<Fq>(v, u1, i);
    sqr<Fq>(t, rr);
    sub<Fq>(t, t, j);
    dbl<Fq>(o.x, v);
    sub<Fq>(o.x, t, o.x);
    sub<Fq>(t, v, o.x);
    mont_mul<Fq>(t, rr, t);
    mont_mul<Fq>(j, s1, j);
    dbl<Fq>(j, j);
    sub<Fq>(o.y, t, j);
    add<Fq>(t, p.z, q.z);
    sqr<Fq>(t, t);
    sub<Fq>(t, t, z1z1);
    sub<Fq>(t, t, z2z2);
    mont_mul<Fq>(o.z, t, h);
    if (x_eq) {
#pragma unroll
        for (int k = 0; k < 12; ++k) o.z[k] = 0;
    }
}
"""


def patched_header(text: str) -> str:
    """g1.cuh with g1_add replaced by the branch-first form."""
    start = text.index(SELECT_ADD_START)
    end = text.index("\n}\n", start) + 3
    return text[:start] + BRANCH_FIRST_ADD + text[end:]


def build(src: str, variant: str, out_dir: str):
    from snarkos_tpu_torch.ops import _build

    d = os.path.join(ROOT, "build", "add_sass", variant)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(_build.CSRC):
        if f.endswith(".cuh"):
            with open(os.path.join(_build.CSRC, f)) as fh:
                text = fh.read()
            if f == "g1.cuh" and variant.startswith("branch"):
                text = patched_header(text)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
    name = os.path.splitext(os.path.basename(src))[0]
    shutil.copy(src, os.path.join(d, f"{name}.cu"))
    lib = os.path.join(d, f"lib{name}.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                          os.path.join(d, f"{name}.cu")], capture_output=True, text=True)
    tag = f"{name}-{variant}"
    with open(os.path.join(out_dir, f"{tag}.ptxas.txt"), "w") as fh:
        fh.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {tag} failed:\n{res.stderr[-4000:]}")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    with open(os.path.join(out_dir, f"{tag}.sass.txt"), "w") as fh:
        fh.write(sass)
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "stack" in ln or "spill" in ln or "Compiling" in ln]
    return lib, sass_stats(sass), ptxas


def sass_stats(sass: str):
    """Per function: instructions, LDL, STL, CALL, RET, BRA."""
    stats, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            stats[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if fn and m:
            op = m.group(1).split(".")[0]
            stats[fn]["instructions"] += 1
            if op in ("LDL", "STL", "CALL", "RET", "BRA", "BAR", "BSSY", "BSYNC", "WARPSYNC"):
                stats[fn][op] += 1
    return {f: dict(c) for f, c in stats.items()}


def run_new(lib, sums):
    import torch

    from snarkos_tpu_torch.ops import _build, msm_kernels

    fn = getattr(ctypes.CDLL(lib), "jadd_bucket_total")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B = sums[0].shape[-1]
    T, s = msm_kernels.BUCKET_THREADS, msm_kernels.BUCKET_PER_THREAD
    out = [torch.empty((24, 1), dtype=torch.int32, device=sums[0].device) for _ in range(3)]
    scratch = torch.empty(2 * 36 * (-(-(B - 1) // (T * s))), dtype=torch.int32,
                          device=sums[0].device)
    args = ((*sums, *out, None, None, None, scratch), (B, T, s), sums[0].device)
    try:
        _build.launch(fn, *args)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return None, str(exc)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        _build.launch(fn, *args)
    end.record()
    torch.cuda.synchronize()
    return out, f"ok, {start.elapsed_time(end) / 20:.4f} ms a launch (20 back to back)"


def run_old(lib, xs):
    import torch

    from snarkos_tpu_torch.ops import _build

    fn = getattr(ctypes.CDLL(lib), "jadd_scan")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = [torch.empty_like(xs[0]) for _ in range(3)]
    try:
        _build.launch(fn, (*xs, *out), (72, 128, 8), xs[0].device)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return None, str(exc)
    return out, "ok"


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_add_sass: no CUDA device", file=sys.stderr)
        return 2
    from snarkos_tpu_torch.ops import _build, g1, msm_kernels
    from snarkos_tpu_torch.ops.puzzle import PuzzleSRS

    out_dir = os.path.join(ROOT, "chiprun_out", "add_sass")
    os.makedirs(out_dir, exist_ok=True)
    sources = [os.path.join(_build.CSRC, "jadd_scan.cu")] + ([args.old] if args.old else [])
    libs, report = {}, {}
    for src in sources:
        for variant in ("select", "branch_first"):
            lib, stats, ptxas = build(src, variant, out_dir)
            key = f"{os.path.basename(src)} {variant}"
            libs[key] = lib
            report[key] = {"ptxas": ptxas, "sass": stats}
            print(key, json.dumps(ptxas), flush=True)
            for fn, st in stats.items():
                print(f"  {fn}: {json.dumps(st)}", flush=True)

    srs = PuzzleSRS.dev(14)
    B = (1 << 13) + 1
    sums = [t[:, :B].contiguous().clone() for t in (srs.points.x, srs.points.y, srs.points.z)]
    sums[2][:, ::16] = 0
    want = g1.JacobianPoints(*msm_kernels.bucket_total_plain(*sums)[0])
    new = os.path.basename(sources[0])
    for variant in ("select", "branch_first"):
        got, status = run_new(libs[f"{new} {variant}"], sums)
        same = None if got is None else bool(g1.same_points(g1.JacobianPoints(*got), want).all())
        report[f"{new} {variant}"]["run"] = {"status": status, "same_points_as_plain": same}
        print(f"{new} {variant}: {status}, T_w same point as plain: {same}", flush=True)
    if args.old:
        old = os.path.basename(args.old)
        n = 72 * 128
        xs = [t[:, :n].reshape(24, 72, 128).contiguous() for t in (
            srs.points.x, srs.points.y, srs.points.z)]
        outs = {}
        for variant in ("select", "branch_first"):
            outs[variant], status = run_old(libs[f"{old} {variant}"], xs)
            report[f"{old} {variant}"]["run"] = {"status": status}
            print(f"{old} {variant}: {status}", flush=True)
        if all(o is not None for o in outs.values()):
            eq = all(torch.equal(a, b) for a, b in zip(outs["select"], outs["branch_first"]))
            report[f"{old} branch_first"]["run"]["limbs_equal_to_select"] = eq
            print(f"{old}: branch-first limbs == select limbs: {eq}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    report["card"] = card
    with open(os.path.join(out_dir, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
