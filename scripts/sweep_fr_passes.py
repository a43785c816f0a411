"""The design choices of B1's Fr passes (``csrc/fr_passes.cu``), swept on
the card.

    python3 scripts/sweep_fr_passes.py [--reps 5]

Builds copies of ``csrc/fr_passes.cu`` into ``build/fr_sweep/`` (one nvcc
each, all started together, with the package's flags), each with one
design choice undone:

- ``sqr=mont_mul``: the s-box's squarings as field.cuh's multiply (a a), not
  the 36-product squaring and one wide reduction;
- ``rows=mont_mul``: each MDS row as t reduced multiplies and t - 1 field
  adds, not t unreduced products and one reduction;
- ``unrolled``: the loops over slots and rows of a full round and the
  s-box's squarings unrolled (no rotation of the state);
- ``no prefetch``: the epoch program without its L1 prefetch of the next
  step's inputs between the cluster barrier's arrive and wait.

For each build it reports ptxas's registers, stack and spills for both
widths, then times ``fr_poseidon_permute`` on one state at (3, 16, 32768),
(3, 16, 65536), (3, 16, 2^22) and (5, 16, 4096) (edge lanes 0, 1, p - 1),
and ``fr_epoch_program`` of the test fixture's epoch at (16, 8, 4096) and
(16, 16, 4096) with clusters of 8 and of 16 blocks, holding every output
limb for limb to the committed build's (CUDA events around one launch,
median of ``--reps`` after a warm-up). Prints a line per
measurement and, last, one JSON line with the card's name and power limit,
also written to ``chiprun_out/fr_sweep.json``. Needs nvcc and a CUDA
device.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SQR_WIDE = """    uint32_t t[WIDE];
    sqr_wide(t, a);
    redc_wide(r, t);
"""
ROW_LAZY = """    uint32_t acc[WIDE];
    mul_wide(acc, s[0], m[0]);
#pragma unroll
    for (int j = 1; j < T; ++j) {
        uint32_t prod[WIDE];
        mul_wide(prod, s[j], m[j]);
        add_wide(acc, prod);
    }
    redc_wide(r, acc);
"""
ROW_PLAIN = """    mont_mul<Fr>(r, s[0], m[0]);
#pragma unroll
    for (int j = 1; j < T; ++j) {
        uint32_t prod[FN];
        mont_mul<Fr>(prod, s[j], m[j]);
        add<Fr>(r, r, prod);
    }
"""
# name: [(text of the committed source, its replacement)]
VARIANTS = {
    "committed": [],
    "sqr=mont_mul": [(SQR_WIDE, "    mont_mul<Fr>(r, a, a);\n")],
    "rows=mont_mul": [(ROW_LAZY, ROW_PLAIN)],
    "unrolled": [
        ("#pragma unroll 1\n    for (int i = 0; i < 4; ++i) fr_sqr(y, y);",
         "#pragma unroll\n    for (int i = 0; i < 4; ++i) fr_sqr(y, y);"),
        ("#pragma unroll 1\n    for (int i = 0; i < T; ++i) {\n        add<Fr>(s[0]",
         "#pragma unroll\n    for (int i = 0; i < T; ++i) {\n        add<Fr>(s[0]"),
        ("#pragma unroll 1\n    for (int i = 0; i < T; ++i) {\n        dot_row",
         "#pragma unroll\n    for (int i = 0; i < T; ++i) {\n        dot_row")],
    "no prefetch": [("        if (threadIdx.x < nb && s + 1 < steps) {",
                     "        if (false) {")],
}
PERMUTE_SHAPES = ((2, 32768), (2, 65536), (2, 1 << 22), (4, 4096))  # (rate, lanes)


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"fr_passes.cu: no single occurrence of {old[:40]!r}")
        src = src.replace(old, new)
    return src


def build_all(_build, out_dir):
    """{variant: (library path, ptxas lines)}, one nvcc a variant at once."""
    with open(os.path.join(_build.CSRC, "fr_passes.cu")) as fh:
        src = fh.read()
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for v, edits in VARIANTS.items():
        tag = re.sub(r"\W+", "_", v)
        cu = os.path.join(out_dir, f"fr_passes_{tag}.cu")
        with open(cu, "w") as fh:
            fh.write(patched(src, edits))
        lib = os.path.join(out_dir, f"libfr_passes_{tag}.so")
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
    """{kernel: {registers, stack, spill_stores}} from ptxas's -v lines."""
    out, fn = {}, None
    for ln in lines:
        head = re.search(r"Compiling entry function '(\w+)'", ln)
        if head:
            fn = {"_Z18fr_poseidon_kernelILi3EEvPKiS1_S1_S1_Pilll": "poseidon<3>",
                  "_Z18fr_poseidon_kernelILi5EEvPKiS1_S1_S1_Pilll": "poseidon<5>"}.get(
                      head.group(1), head.group(1))
            out[fn] = {}
        elif fn and "bytes stack frame" in ln and "stack" not in out[fn]:
            out[fn]["stack"] = int(re.search(r"(\d+) bytes stack frame", ln).group(1))
            out[fn]["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif fn and "Used" in ln and "registers" in ln:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_fr_passes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from snarkos_tpu_torch.ops import _build, poseidon
    from snarkos_tpu_torch.ops import puzzle as puzzle_mod
    from snarkos_tpu_torch.ops.fieldspec import FR

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    built = build_all(_build, os.path.join(ROOT, "build", "fr_sweep"))
    report = {"card": card, "variants": {}}
    fns, programs = {}, {}
    for v, (lib, ptxas) in built.items():
        for table, symbol in ((fns, "fr_poseidon_permute"), (programs, "fr_epoch_program")):
            fn = getattr(ctypes.CDLL(lib), symbol)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            table[v] = fn
        report["variants"][v] = {"ptxas": ptxas_report(ptxas), "ms": {}}
        print(f"{v}: {report['variants'][v]['ptxas']}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(1516)

    def median_ms(run):
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    for rate, lanes in PERMUTE_SHAPES:
        t = rate + 1
        x = np.ascontiguousarray(FR.random(t * lanes, rng).reshape(FR.nlimbs, t, lanes)
                                 .transpose(1, 0, 2))
        x[:, :, :3] = FR.encode_fast([0, 1, FR.p - 1], mont=True)[None]
        st = torch.from_numpy(x).to(dev)
        consts = poseidon.kernel_consts(rate).to(dev)
        outs = {}
        for v, fn in fns.items():
            out = torch.empty_like(st)

            def run(fn=fn, out=out):
                _build.launch(fn, (st, None, None, consts, out), (lanes, t, 0, t), dev)

            ms = median_ms(run)
            outs[v] = out
            if not torch.equal(out, outs["committed"]):
                raise AssertionError(f"{v} at ({t}, 16, {lanes}): output differs from the "
                                     "committed build's")
            report["variants"][v]["ms"][f"({t}, 16, {lanes})"] = ms
            print(f"{v} permute ({t}, 16, {lanes}): {ms:.4f} ms, output equal to the committed "
                  f"build's on {card}", flush=True)
        del st, outs
        torch.cuda.empty_cache()

    fixture = json.load(open(os.path.join(ROOT, "tests", "fixtures",
                                          "torch_puzzle_k12_b8.json")))
    prog = puzzle_mod.EpochProgram(bytes.fromhex(fixture["epoch_hash"]), 4096, dev)
    sels = prog.sels.reshape(puzzle_mod.EPOCH_STEPS, -1).contiguous()
    perms, consts = prog.perms.contiguous(), prog.consts.contiguous()
    for batch in (8, 16):
        v = torch.from_numpy(FR.random(batch * 4096, rng).reshape(FR.nlimbs, batch, 4096)).to(dev)
        want = None
        for cluster in (8, 16):
            for name, fn in programs.items():
                out = torch.empty_like(v)

                def run(fn=fn, out=out, cluster=cluster):
                    _build.launch(fn, (v, perms, sels, consts, out),
                                  (batch, 4096, puzzle_mod.EPOCH_STEPS, cluster), dev)

                ms = median_ms(run)
                want = out if want is None else want
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} epoch program b{batch}, clusters of {cluster}: "
                                         "output differs from the committed build's")
                report["variants"][name]["ms"][f"epoch (16, {batch}, 4096) cluster {cluster}"] = ms
                print(f"{name} epoch program (16, {batch}, 4096), clusters of {cluster}: "
                      f"{ms:.4f} ms on {card}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    line = json.dumps(report)
    with open(os.path.join(ROOT, "chiprun_out", "fr_sweep.json"), "w") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
