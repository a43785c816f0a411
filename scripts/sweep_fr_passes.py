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
  step's inputs between the cluster barrier's arrive and wait;
- ``leaves at step 0``: the global epoch program without its packing pass
  and the grid barrier after it, step 0 reading x and its partner from the
  leaves' limbs (nonce-major);
- ``4 blocks an SM``: the global epoch program's registers capped so that
  four blocks of 256 threads fit an SM (``__launch_bounds__(256, 4)``);
- ``128 threads``: the global epoch program in blocks of 128 threads;
- ``l2 window``: the global epoch program launched with a persisting-L2
  access window over its two buffers (``cudaLaunchKernelEx``, the device's
  largest persisting carve-out, the hit ratio the carve-out over the
  window); the carve-out is device-wide, so the entry waits for the launch
  and resets it (``cudaCtxResetPersistingL2Cache``, limit 0), and its time
  includes that wait.

For each build it reports ptxas's registers, stack and spills for both
widths, then times ``fr_poseidon_permute`` on one state at (3, 16, 32768),
(3, 16, 65536), (3, 16, 2^22) and (5, 16, 4096) (edge lanes 0, 1, p - 1),
``fr_epoch_program`` of the test fixture's epoch at (16, 8, 4096) and
(16, 16, 4096) with clusters of 8 and of 16 blocks, and
``fr_epoch_program_global`` at (16, 8, 4096), (16, 8, 2^16) and (16, 2,
2^20) (a run of 3 launches, its time over 3), holding every output limb
for limb to the committed build's (CUDA events around one launch,
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
PACK_PASS = """    for (uint32_t e = first; e < n; e += stride) {  // the leaves into buffer 0
        const uint32_t b = e / K, k = e - b * K;
        uint32_t x[FN];
        load<Fr>(x, v, n, e);
        pack(scratch + 2 * (static_cast<int64_t>(k) * B + b), x);
    }
    grid.sync();
"""
BUFFER_READS = """            unpack_cg(x, cur + 2 * (static_cast<int64_t>(k) * B + b));
            unpack_cg(u, cur + 2 * (static_cast<int64_t>(j) * B + b));
"""
LIMB_READS = """            if (s == 0) {
                load<Fr>(x, v, n, static_cast<int64_t>(b) * K + k);
                load<Fr>(u, v, n, static_cast<int64_t>(b) * K + j);
            } else {
    """ + BUFFER_READS.replace("\n", "\n    ").rstrip() + """
            }
"""
COOP_LAUNCH = """    err = cudaLaunchCooperativeKernel((const void*)fr_epoch_program_global_kernel,
                                      dim3(static_cast<unsigned>(blocks)), dim3(threads), args, 0,
                                      static_cast<cudaStream_t>(stream));
"""
WINDOW_LAUNCH = """    (void)args;
    int max_window = 0, max_persist = 0;
    cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
    cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, static_cast<size_t>(max_persist));
    size_t window = 64 * static_cast<size_t>(n);
    if (window > static_cast<size_t>(max_window)) window = static_cast<size_t>(max_window);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    attr[1].id = cudaLaunchAttributeAccessPolicyWindow;
    attr[1].val.accessPolicyWindow.base_ptr = buf;
    attr[1].val.accessPolicyWindow.num_bytes = window;
    attr[1].val.accessPolicyWindow.hitRatio =
        window > static_cast<size_t>(max_persist) ? float(max_persist) / float(window) : 1.0f;
    attr[1].val.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    attr[1].val.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
    err = cudaLaunchKernelEx(&cfg, fr_epoch_program_global_kernel, v, ps, words, out, buf, b32,
                             k32, steps);
    if (err == cudaSuccess) err = cudaStreamSynchronize(cfg.stream);
    cudaCtxResetPersistingL2Cache();
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
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
    "leaves at step 0": [
        (PACK_PASS, ""),
        ("            if (last) {\n                b = e / K;",
         "            if (last || s == 0) {\n                b = e / K;"),
        (BUFFER_READS, LIMB_READS)],
    "4 blocks an SM": [
        ("__launch_bounds__(EPOCH_GLOBAL_THREADS)\n    fr_epoch_program_global_kernel(",
         "__launch_bounds__(EPOCH_GLOBAL_THREADS, 4)\n    fr_epoch_program_global_kernel(")],
    "128 threads": [("constexpr int EPOCH_GLOBAL_THREADS = 256;",
                     "constexpr int EPOCH_GLOBAL_THREADS = 128;")],
    "l2 window": [(COOP_LAUNCH, WINDOW_LAUNCH)],
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
    fns, programs, globals_ = {}, {}, {}
    for v, (lib, ptxas) in built.items():
        for table, symbol, ptrs, ints in ((fns, "fr_poseidon_permute", 6, 4),
                                          (programs, "fr_epoch_program", 4, 4),
                                          (globals_, "fr_epoch_program_global", 5, 3)):
            fn = getattr(ctypes.CDLL(lib), symbol)
            fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int64] * ints + [ctypes.c_void_p]
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
                _build.launch(fn, (st, None, None, consts, out, None), (lanes, t, 0, t), dev)

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
    ps, cw = prog.side_tables()
    for batch in (8, 16):
        v = torch.from_numpy(FR.random(batch * 4096, rng).reshape(FR.nlimbs, batch, 4096)).to(dev)
        want = None
        for cluster in (8, 16):
            for name, fn in programs.items():
                out = torch.empty_like(v)

                def run(fn=fn, out=out, cluster=cluster):
                    _build.launch(fn, (v, ps, cw, out),
                                  (batch, 4096, puzzle_mod.EPOCH_STEPS, cluster), dev)

                ms = median_ms(run)
                want = out if want is None else want
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} epoch program b{batch}, clusters of {cluster}: "
                                         "output differs from the committed build's")
                report["variants"][name]["ms"][f"epoch (16, {batch}, 4096) cluster {cluster}"] = ms
                print(f"{name} epoch program (16, {batch}, 4096), clusters of {cluster}: "
                      f"{ms:.4f} ms on {card}", flush=True)
    for batch, k in ((8, 4096), (8, 1 << 16), (2, 1 << 20)):
        gprog = puzzle_mod.EpochProgram(bytes.fromhex(fixture["epoch_hash"]), k, dev)
        ps, cw = gprog.side_tables()
        v = torch.from_numpy(FR.random(batch * k, rng).reshape(FR.nlimbs, batch, k)).to(dev)
        want = None
        for name, fn in globals_.items():
            out, scratch = torch.empty_like(v), torch.empty_like(v)

            def run(fn=fn, out=out, scratch=scratch):
                for _ in range(3):
                    _build.launch(fn, (v, ps, cw, out, scratch),
                                  (batch, k, puzzle_mod.EPOCH_STEPS), dev)

            ms = median_ms(run) / 3
            want = out if want is None else want
            if not torch.equal(out, want):
                raise AssertionError(f"{name} global epoch program (16, {batch}, {k}): output "
                                     "differs from the committed build's")
            report["variants"][name]["ms"][f"epoch global (16, {batch}, {k})"] = ms
            print(f"{name} global epoch program (16, {batch}, {k}): {ms:.4f} ms on {card}",
                  flush=True)
        del gprog, ps, cw, v, want, out, scratch
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    line = json.dumps(report)
    with open(os.path.join(ROOT, "chiprun_out", "fr_sweep.json"), "w") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
