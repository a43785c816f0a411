"""Chip check of the PyTorch port (snarkos_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:
  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
     and nvcc versions; build every kernel from snarkos_tpu_torch/csrc, one
     nvcc per source, all at once.
  2. every kernel of the main path (B1 mont_mul, B2 g1_add, B3 seg_combine,
     B4 bucket_scan_serial) against its plain PyTorch version on the card, at
     the main path's shapes, with edge lanes; the comparison is exact
     (tolerance 0: the arithmetic is integer). Times: median of 7 runs of 20
     back-to-back launches for a kernel, of 5 single calls for its plain
     version.
  3. the main path: Puzzle(log_degree=12).prove_batch over 8 nonces on the
     card, checked byte for byte against tests/fixtures/torch_puzzle_k12_b8.json,
     against C = p(tau) G and W = q(tau) G computed on the host from the
     coefficients and the known dev tau, and against prove_batch of one
     nonce; every kernel's launch counter must grow during that call. Then
     solutions/s at batch 8 (median of 3 timed calls).
  4. one JSON line with every kernel's numbers, then the result line.

The script imports nothing of JAX or of the JAX package (snarkos_tpu).
Details go to chiprun_out/chip_smoke.json.
"""

import json
import os
import random
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

BATCH = 8

# Published H100 SXM peaks (NVIDIA's H100 datasheet): 3.35 TB/s of HBM and
# 67 TFLOP/s of float32 outside the tensor cores, i.e. 33.5 T fused
# multiply-adds/s. Hopper issues 32-bit integer multiply-adds at half the
# float32 FMA rate (64 against 128 per SM and clock), so 16.75 T/s; a 32x32
# -> 64-bit word product costs two of them (low and high halves).
HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 67e12 / 2 / 2
FQ_MUL_OPS = 2 * (2 * 12 * 12 + 12)  # CIOS word products x 2 per Fq multiply
FR_MUL_OPS = 2 * (2 * 8 * 8 + 8)


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps, inner=1):
    """Median over ``reps`` runs of the device time of ``inner`` back-to-back
    calls, divided by ``inner`` (CUDA events around the whole run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch

    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from snarkos_tpu_torch.crypto import params
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1
    from snarkos_tpu_torch.ops import _build, g1, g1_kernels, msm, msm_kernels
    from snarkos_tpu_torch.ops import modarith as fa
    from snarkos_tpu_torch.ops.fieldspec import FQ, FR
    from snarkos_tpu_torch.ops.puzzle import DEV_TAU, Puzzle

    with open(os.path.join(HERE, "tests", "fixtures", "torch_puzzle_k12_b8.json")) as fh:
        fixture = json.load(fh)
    dev = torch.device("cuda")
    report = {}

    # -- 1. environment and build ---------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvcc: {nvcc}")
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    log(f"built {len(_build.SOURCES)} kernels in {build_s:.1f} s")
    regs = {}
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        regs[name] = lines
        for ln in lines:
            log(f"  {name}: {ln}")
    report.update(card=smi, torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
                  build_s=build_s, ptxas=regs)

    rng = np.random.default_rng(1234)
    prng = random.Random(1234)

    def field_operands(spec, n):
        a = spec.random(n, rng)
        b = spec.random(n, rng)
        edge = [0, 1, spec.p - 1, spec.p - 2]  # canonical values, as limbs
        ea = spec.encode_fast(edge + [spec.p - 1, 0])
        eb = spec.encode_fast([spec.p - 1, spec.p - 1, spec.p - 1, 1] + [spec.p - 1, 0])
        a[:, :ea.shape[1]] = ea
        b[:, :eb.shape[1]] = eb
        return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)

    # host points: multiples of a random point, then Jacobian rescaling
    H = ref_g1.scalar_mul(prng.randrange(1, params.FR_MODULUS), ref_g1.GENERATOR)
    multiples, acc = [], H
    for _ in range(4096):
        multiples.append(ref_g1.from_affine(ref_g1.affine(acc)))
        acc = ref_g1.add(acc, H)

    def rescale(p):
        """Another Jacobian representative of the same point."""
        if not p[2]:
            return p
        x, y = ref_g1.affine(p)
        lam = prng.randrange(1, FQ.p)
        return (x * lam * lam % FQ.p, y * lam ** 3 % FQ.p, lam)

    def point_pairs(n):
        P = [rescale(multiples[prng.randrange(4096)]) for _ in range(n)]
        Q = [rescale(multiples[prng.randrange(4096)]) for _ in range(n)]
        P[0] = rescale(Q[0])                                      # P == Q
        P[1] = rescale(ref_g1.neg(Q[1]))                          # P == -Q
        P[2] = ref_g1.INFINITY                                    # P = 0
        Q[3] = ref_g1.INFINITY                                    # Q = 0
        P[4], Q[4] = ref_g1.INFINITY, ref_g1.INFINITY             # both
        P[5] = (prng.randrange(FQ.p), prng.randrange(FQ.p), 0)    # odd identity
        n_dbl = sum(1 for p, q in zip(P, Q) if p[2] and q[2]
                    and ref_g1.affine(p) == ref_g1.affine(q))
        if n_dbl < 1 or ref_g1.affine(P[1]) != ref_g1.affine(ref_g1.neg(Q[1])):
            raise AssertionError("edge lanes P == Q and P == -Q were not built")
        return g1.encode_points(P, dev), g1.encode_points(Q, dev), n_dbl

    kernels = []

    def check(name, source, replaces, cases, counter):
        """cases: [(label, kernel_fn, plain_fn, nbytes, nops)]"""
        shapes = []
        for label, kfn, pfn, nbytes, nops in cases:
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err != 0:
                raise AssertionError(f"{name} {label}: kernel != plain (max abs err {err})")
            ms = cuda_ms(kfn, 7, inner=20)
            plain_ms = cuda_ms(pfn, 5)
            b_ms, b_by = bound(nbytes, nops)
            shapes.append({"shape": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by})
            log(f"{name} {label}: exact; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.5f} ms ({b_by})")
        main_case = shapes[0]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "counter": counter, "max_abs_err": max(s["max_abs_err"] for s in shapes),
                        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                        "library_ms": None, "shapes": shapes})

    # -- 2. kernels against their plain versions at the path's shapes ----------
    n = BATCH * 4096
    b1 = []
    for spec, ops in ((FR, FR_MUL_OPS), (FQ, FQ_MUL_OPS)):
        a, b = field_operands(spec, n)
        b1.append((f"{spec.name} ({spec.nlimbs}, {n})",
                   lambda a=a, b=b, s=spec: fa.mont_mul_kernel(s, a, b),
                   lambda a=a, b=b, s=spec: fa.mont_mul_plain(s, a, b),
                   3 * spec.nlimbs * 4 * n, ops * n))
    check("mont_mul", "snarkos_tpu_torch/csrc/mont_mul.cu",
          "snarkos_tpu/ops/modarith.py:171", b1, fa.mont_mul_kernel)

    def coords(p):
        return (p.x, p.y, p.z)

    b2 = []
    for width in (264, 8):
        pa, pb, n_dbl = point_pairs(width)
        b2.append((f"(24, {width})",
                   lambda pa=pa, pb=pb: coords(g1_kernels.add_kernel(pa, pb)),
                   lambda pa=pa, pb=pb: coords(g1.add(pa, pb)),
                   9 * 24 * 4 * width, (16 * width + 7 * n_dbl) * FQ_MUL_OPS))
    check("g1_add", "snarkos_tpu_torch/csrc/g1_add.cu", "snarkos_tpu/ops/g1_pallas.py:67",
          b2, g1_kernels.add_kernel)

    # a real window of the batch-8 multi-MSM: base = 4096 affine points tiled
    # 8 times, random scalars, c = 6, K = 256 chains of m = 128
    base = g1.encode_points(multiples, dev)
    scalars = torch.from_numpy(FR.random(n, rng)).to(dev)  # canonical Fr values
    c = msm.fused_window_bits(4096)
    K = msm._default_lanes(n)
    B = (1 << (c - 1)) + 1
    x = base.x.repeat(1, BATCH)
    ycat = torch.cat([base.y.repeat(1, BATCH), fa.neg(FQ, base.y).repeat(1, BATCH)], dim=-1)
    packed = msm.signed_window_digits(scalars, c)
    batch_off = (torch.arange(n, device=dev) // 4096) * B
    _, xs, ys, heads = msm.chain_layout(x, ycat, packed[packed.shape[0] // 2], K, batch_off)
    m = n // K
    # edge cases inside chains: P == Q (doubling) and P == -Q (identity)
    xs, ys, heads = xs.clone(), ys.clone(), heads.clone()
    for k in range(4):
        xs[:, 5, k], ys[:, 5, k], heads[5, k] = xs[:, 4, k], ys[:, 4, k], 0
    for k in range(4, 8):
        xs[:, 5, k], heads[5, k] = xs[:, 4, k], 0
        ys[:, 5, k] = fa.neg(FQ, ys[:, 4, k:k + 1])[:, 0]
    flags = heads.unsqueeze(0).contiguous()

    def seg_case(width, fl):
        pa, pb, n_dbl = point_pairs(width)
        fa_ = torch.from_numpy(rng.integers(0, 2, size=(1, width), dtype=np.int32)).to(dev)
        fb_ = fl.to(torch.int32).reshape(1, width).contiguous()
        a = (fa_, pa.x, pa.y, pa.z)
        b = (fb_, pb.x, pb.y, pb.z)
        n_add = int((fb_ == 0).sum())
        return (f"(24, {width})", lambda: g1_kernels.seg_combine_kernel(a, b),
                lambda: g1_kernels.seg_combine_plain(a, b),
                (2 * 1 + 6 * 24 + 1 + 3 * 24) * 4 * width, (16 * n_add + 7 * n_dbl) * FQ_MUL_OPS)

    chain_flags = heads.max(0).values  # (K,) the cross-chain carry scan's flags
    seg_flags = (torch.arange(BATCH * B, device=dev) % B == 0)  # per-batch suffix scans
    check("seg_combine", "snarkos_tpu_torch/csrc/seg_combine.cu",
          "snarkos_tpu/ops/g1_pallas.py:98",
          [seg_case(K, chain_flags), seg_case(BATCH * B, seg_flags)], g1_kernels.seg_combine_kernel)

    n_heads = int(flags.sum())
    check("bucket_scan_serial", "snarkos_tpu_torch/csrc/bucket_scan_serial.cu",
          "snarkos_tpu/ops/msm_pallas.py:251",
          [(f"(24, {m}, {K})", lambda: msm_kernels.bucket_scan_serial_kernel(xs, ys, flags),
            lambda: msm_kernels.bucket_scan_serial_plain(xs, ys, flags),
            (2 * 24 * 4 + 4 + 3 * 24 * 4) * m * K,
            ((m * K - n_heads) * 11 + 6 * 4) * FQ_MUL_OPS)],
          msm_kernels.bucket_scan_serial_kernel)

    # -- 3. the main path ---------------------------------------------------------
    t0 = time.perf_counter()
    puzzle = Puzzle(log_degree=fixture["log_degree"])
    torch.cuda.synchronize()
    srs_s = time.perf_counter() - t0
    log(f"Puzzle(log_degree={fixture['log_degree']}) with the dev SRS built on the card "
        f"in {srs_s:.2f} s")
    nonces = [row["nonce"] for row in fixture["solutions"]]
    epoch = bytes.fromhex(fixture["epoch_hash"])
    address = fixture["address"]
    puzzle.prove_batch(epoch, address, nonces)  # warm-up
    torch.cuda.synchronize()

    for kern in kernels:
        kern["counter"].launches = 0
    sols = puzzle.prove_batch(epoch, address, nonces)
    torch.cuda.synchronize()
    for kern in kernels:
        kern["launches"] = kern.pop("counter").launches
    log("launches in one prove_batch(8): " + ", ".join(
        f"{k['name']} {k['launches']}" for k in kernels))
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    if len(sols) != len(nonces):
        raise AssertionError(f"{len(sols)} solutions for {len(nonces)} nonces")
    for row, sol in zip(fixture["solutions"], sols):
        got = (sol.commitment.hex(), str(sol.eval_y), sol.witness.hex(), str(sol.solution_id))
        want = (row["commitment"], row["eval_y"], row["witness"], row["solution_id"])
        if got != want:
            raise AssertionError(f"nonce {row['nonce']}: solution differs from the fixture")
    log("prove_batch(8) matches tests/fixtures/torch_puzzle_k12_b8.json byte for byte")

    # independent check of both MSMs: C = p(tau) G and W = q(tau) G
    coeffs = puzzle.coefficients(epoch, address, nonces)
    r = params.FR_MODULUS
    for i, sol in enumerate(sols):
        cs = FR.decode_fast(coeffs[:, i, :].cpu().numpy(), mont=True)
        p_tau = 0
        for coef in reversed(cs):
            p_tau = (p_tau * DEV_TAU + coef) % r
        z = puzzle._challenge(sol.commitment)
        y = 0
        for coef in reversed(cs):
            y = (y * z + coef) % r
        q_tau = (p_tau - y) * pow(DEV_TAU - z, -1, r) % r
        c_aff = ref_g1.affine(ref_g1.scalar_mul(p_tau, ref_g1.GENERATOR))
        w_aff = ref_g1.affine(ref_g1.scalar_mul(q_tau, ref_g1.GENERATOR))
        enc = lambda a: a[0].to_bytes(48, "little") + a[1].to_bytes(48, "little") + b"\x00"
        if y != sol.eval_y or enc(c_aff) != sol.commitment or enc(w_aff) != sol.witness:
            raise AssertionError(f"nonce {nonces[i]}: C != p(tau) G or W != q(tau) G")
    log("C = p(tau) G and W = q(tau) G hold for all 8 nonces")

    one = puzzle.prove_batch(epoch, address, [nonces[5]])
    if len(one) != 1 or one[0] != sols[5]:
        raise AssertionError("prove_batch of one nonce differs from the batch of eight")
    log("prove_batch(1) == prove_batch(8)[5]")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        puzzle.prove_batch(epoch, address, nonces)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"prove_batch(8): median {med:.3f} s of {[round(t, 3) for t in times]} -> "
        f"{BATCH / med:.3f} solutions/s on {smi}")
    report.update(srs_build_s=srs_s, prove_batch8_s=times, solutions_per_s=BATCH / med)

    # -- 4. output ------------------------------------------------------------------
    line = {"kernels": [{k: v for k, v in kern.items() if k != "shapes"} for kern in kernels]}
    report["kernels"] = kernels
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
