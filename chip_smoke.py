"""Chip check of the PyTorch port (snarkos_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:
  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
     and nvcc versions; build every kernel from snarkos_tpu_torch/csrc, one
     nvcc per source, all at once; the dev SRS of degree 2^20 built on the
     card (its first 2^20 points are the bases of phase 5).
  2. every kernel (B1 mont_mul and its Fr passes fr_poseidon_permute and
     fr_epoch_step; B2 g1_add and its window entry points g1_horner and
     g1_bucket_fixup; B3 seg_prefix, B4 bucket_scan_serial, B5 bucket_scan,
     B6 bucket_scan_fast, B7 jadd_bucket_total) against its plain PyTorch
     version on the card, at the paths' shapes and on real windows of their
     MSMs, with edge lanes; the comparison is exact (tolerance 0: the
     arithmetic is integer). B4-B7 add in another order than their plain
     versions, so they are held to them projectively (g1.same_points;
     max_abs_err is then over the affine normal forms), at each setting of
     their sweeps: B4 and B5 at every position, B6 at every position of a
     live bucket in an unflagged chain (elsewhere its values are don't-care)
     and its exception flags exactly, B7 at the total and at every suffix.
     Times: median of 7 runs of 20 back-to-back launches for a kernel (7 runs
     of 3 at the 2^20 shapes and for the Poseidon permutation), CUDA events
     around each run, which at small widths time the host's launch rate;
     beside it the device time a launch, the same run captured in one CUDA
     graph and replayed (median of 7 replays); of 5 single calls
     for its plain version (of 1 call after a warm-up at the 2^20 shapes and
     for the permutation, where one takes seconds).
  3. Puzzle(log_degree=12).prove_batch over 8 nonces on the card, checked
     byte for byte against tests/fixtures/torch_puzzle_k12_b8.json, against
     C = p(tau) G and W = q(tau) G computed on the host from the coefficients
     and the known dev tau, and against prove_batch of one nonce. Then
     solutions/s at batch 8 (median of 3 timed calls). A call must launch
     fr_poseidon_permute once, fr_epoch_step 12 times and mont_mul at most 80
     times (here and at batch 16).
  4. prove_batch over 16 nonces (the wide-chain engine, B5): nonces 0-7 equal
     to prove_batch(8), all 16 checked on the host as above plus solution_id
     = sha64(C || y); solutions/s at batch 16 (median of 3 after a warm-up).
  5. one MSM of 2^20 points through msm.msm_affine (the fast engine B6, the
     bucket total B7): the result equals (sum k_i tau^i) G computed on the
     host; then with base 1 := base 0 and k_1 := k_0, where B6's flag fires
     and the complete engine (B5) reruns; points/s (median of 3 timed calls).
     A call launches B7 and B3 once a window and B2's g1_add never (twice
     a window each on the rerun).
  6. the generic engine: msm.msm over the first 2^16 dev SRS powers, each
     rescaled to a random z, every 64th the identity, every 97th scalar 0:
     the result equals (sum k_i tau^i) G over the non-identity lanes, and a
     call launches B2's g1_add 2 m W times (m = 16 steps a lane, W = 20
     windows), B3, B7 and g1_horner W times each, and no B4-B6; points/s
     (median of 3).
  7. the verifier: check_binding's B1 launches; Puzzle.verify_batch over the
     first 4 solutions of phase 3 and verify of each accept, eval_y + 1 and
     swapped witnesses reject, check_structural refuses x >= q;
     kzg.batch_verify over their openings runs on the fused engine (B4, no
     g1_add), with a constant polynomial's opening (W the identity) on the
     generic one (g1_add, no B4), both accept, and reject once that
     opening's y changes. Times: verify_batch(4), its check_bindings,
     batch_verify and the host pairing_check apart (medians of 3).
  8. the SRS artifact: the degree-2^12 dev SRS saved with save_srs and
     loaded by PuzzleSRS.from_artifact (the consistency check's MSMs on B4)
     gives the same device points and tau H; a copy with one power changed
     fails the consistency check.
  9. the NTT over Fr and the pipeline: B1's NTT entry fr_ntt_pass against
     its plain version, limb for limb, at every pass of the plans for 2^12,
     2^16, 2^20, 2^22 and (16, 8, 2^16), forward and inverse (n^-1 in the
     first pass), with every pair of 0, 1, p - 1, p - 2 as the (u, v) of a
     butterfly at the first, middle and last stage of each pass (planted at
     that stage's input and undone in plain PyTorch back to the pass's
     input); the first pass at 2^22 timed beside index_select of the same
     permutation. ntt at 2^22: intt(ntt(a)) == a, ntt(a) == ntt_plain(a),
     ntt(a)[k] == poly_eval(a, omega^k) on the host at k = 0 and 4 random
     k; ntt and intt at 2^12 and 2^16 equal to the host crypto/ref/ntt.py;
     each row of ntt_batched over (16, 8, 2^16) equal to ntt of the row. A
     transform of 2^k launches fr_ntt_pass len(ntt._pass_plan(k)) times
     and nothing else. ntt elems/s at 2^12-2^22 and intt at 2^22 (median
     of 3 host-clock calls, and the device time of a CUDA graph replay);
     the device time of each pass at 2^22; the sweep of plans, tiles and
     block sizes at 2^22 and 2^20. The pipeline of entry.entry()
     (Poseidon, ntt, square) at 2^10 equal limb for limb to the host
     composition, then at 2^22 (one permutation, len(plan) passes, one
     mont_mul) against the host Poseidon at 8 lanes and the plain ntt and
     square; its wall time (median of 3).
 10. one JSON line with every kernel's numbers, then the result line.
Every path runs with the launch counters set to 0 just before it and read
just after; each must launch the kernels it is built from, and every kernel
must launch on some path, but those of NO_PATH_YET (none now), which must
not.

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
BATCH_WIDE = 16
LOG_N = 20
TEAM_SWEEP = (16, 32, 64, 128)  # B4's threads per chain
WIDE_TEAM_SWEEP = (4, 8, 16, 32)  # B5's and B6's threads per chain
# B7's (threads a block, buckets a thread) at the 2^20 MSM's B = 2^13 + 1,
# and the few also run at the c = 16 MSM's B = 2^15 + 1
TOTAL_SWEEP = tuple((t, s) for t in (32, 64, 128, 256) for s in (1, 2, 4))
TOTAL_SWEEP_WIDE = ((64, 1), (128, 1), (256, 1), (256, 2))
# kernels that no path launches yet, with their next caller: held against
# their plain versions, exempt from the "launched on no path" check, and a
# failure if a path does launch them
NO_PATH_YET = {}
# the generic engine's MSM (phase 6): 2^16 Jacobian bases, c = 13, K = 4096
# lanes of m = 16 steps, W = 20 windows
LOG_GENERIC = 16
GENERIC_C = 13
GENERIC_K = 4096
# the verifier (phase 7): a block's solutions, MAX_SOLUTIONS_PER_BLOCK
VERIFY_BATCH = 4
# the NTT (phase 9): BASELINE config #2's single-card sizes, the batched
# transform's (rows, log2 n), and the pipeline's log2 n
NTT_LOGS = (12, 16, 20, 22)
NTT_BATCH = (8, 16)
PIPE_LOG = 22
# the NTT's sweep at 2^22 and 2^20: stages a pass at most (the plan), log2 of
# a tile's elements, threads a block
NTT_SWEEP_K_MAX = (6, 8)
NTT_SWEEP_LOG_ELEMS = (9, 10, 11)
NTT_SWEEP_THREADS = (128, 256, 512)
# B1's launches a prove_batch call (PERF.md): one permutation, the epoch
# program's 12 steps, at most 80 single multiplies (KZG eval, conversions)
PATH_LAUNCHES = {"fr_poseidon_permute": 1, "fr_epoch_step": 12}
MONT_MUL_MAX = 80

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
    calls, divided by ``inner`` (CUDA events around the whole run). At small
    widths this is the rate at which the host launches them."""
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


def graph_ms(fn, reps, inner):
    """The card's own time a call: ``inner`` calls captured in one CUDA
    graph, then the median over ``reps`` replays (CUDA events around each)
    divided by ``inner``. A replay launches them back to back, so the card
    never waits for the host."""
    import torch

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
    del graph
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


T_START = time.perf_counter()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from snarkos_tpu_torch import entry as entry_mod
    from snarkos_tpu_torch.crypto import params, srs_artifact
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg, ntt as ref_ntt, pairing
    from snarkos_tpu_torch.crypto.ref import poseidon as ref_poseidon
    from snarkos_tpu_torch.ops import _build, g1, g1_kernels, kzg, msm, msm_kernels, ntt, poseidon
    from snarkos_tpu_torch.ops import modarith as fa
    from snarkos_tpu_torch.ops import puzzle as puzzle_mod
    from snarkos_tpu_torch.ops.fieldspec import FQ, FR
    from snarkos_tpu_torch.ops.puzzle import DEV_TAU, Puzzle, PuzzleSRS, sha64

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
    t0 = time.perf_counter()
    srs = PuzzleSRS.dev(LOG_N)
    torch.cuda.synchronize()
    report["srs20_build_s"] = time.perf_counter() - t0
    log(f"dev SRS of degree 2^{LOG_N} built on the card in {report['srs20_build_s']:.1f} s")

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
        return g1.encode_points(P, dev), g1.encode_points(Q, dev), add_ops(P, Q)

    def add_ops(P, Q):
        """Multiplies of the complete adds P + Q as g1.cuh runs them: none
        with an identity operand, 8 + 7 Fq products for P == Q, 16 else.
        Raises unless the lanes hold P == Q and P == -Q."""
        fin = [(p, q) for p, q in zip(P, Q) if p[2] and q[2]]
        n_dbl = sum(1 for p, q in fin if ref_g1.affine(p) == ref_g1.affine(q))
        n_neg = sum(1 for p, q in fin if ref_g1.affine(p) == ref_g1.affine(ref_g1.neg(q)))
        if n_dbl < 1 or n_neg < 1:
            raise AssertionError("edge lanes P == Q and P == -Q were not built")
        return (16 * (len(fin) - n_dbl) + 15 * n_dbl) * FQ_MUL_OPS

    kernels = []

    def affine_err(got, want, mask=None):
        """Projective check of two (x, y, z) outputs: every position (where
        ``mask``, if given) must be g1.same_points; returns the max abs error
        of their affine normal forms (x, y, is-identity)."""
        pg, pw = (g1.JacobianPoints(*(t.reshape(24, -1) if mask is None else
                                      t.reshape(24, -1)[:, mask] for t in o))
                  for o in (got, want))
        n, step, bad = pg.x.shape[-1], 1 << 16, 0
        for lo in range(0, n, step):  # the plain products of same_points take memory
            part = [g1.JacobianPoints(*(t[:, lo:lo + step] for t in (p.x, p.y, p.z)))
                    for p in (pg, pw)]
            bad += int((~g1.same_points(*part)).sum())
        if bad:
            raise AssertionError(f"{bad} positions are not the same point")
        return max_abs_err(g1.to_affine(pg), g1.to_affine(pw))

    def check(name, source, replaces, cases, counter, big=False, verify=None, exact=True,
              compare=None, library=None):
        """cases: [(label, kernel_fn, plain_fn, nbytes, nops[, timed_fn])],
        ``timed_fn`` timed in place of kernel_fn if given, a case with nbytes
        None compared and not timed (the first case is timed); ``big``: time
        7 runs of 3 launches and one plain call after a warm-up (else 7 runs of
        20 and 5 plain calls), and the device time over as many launches as a
        run; ``verify``
        checks the kernel's output beyond the comparison with the plain one;
        ``exact=False`` compares projectively (``affine_err``), ``compare``
        with a function (got, want) -> max abs error that raises on a
        mismatch; ``library``, one PyTorch call that computes the first case's
        function, is timed as its library_ms. Cases that share a plain_fn share
        its output and time."""
        shapes = []
        plain_runs = {}
        for label, kfn, pfn, nbytes, nops, *timed in cases:
            if pfn not in plain_runs:
                want = pfn()
                torch.cuda.synchronize()
                plain_runs[pfn] = (want, cuda_ms(pfn, 1 if big else 5))
            want, plain_ms = plain_runs[pfn]
            got = kfn()
            torch.cuda.synchronize()
            if compare is not None:
                err = compare(got, want)
            else:
                err = max_abs_err(got, want) if exact else affine_err(got, want)
            if err != 0:
                raise AssertionError(f"{name} {label}: kernel != plain (max abs err {err})")
            if verify is not None:
                verify(label, got)
            if nbytes is None:  # a case that is compared, not timed
                shapes.append({"shape": label, "max_abs_err": err})
                log(f"{name} {label}: exact")
                continue
            inner = 3 if big else 20
            tfn = timed[0] if timed else kfn
            ms = cuda_ms(tfn, 7, inner=inner)
            dev_ms = graph_ms(tfn, 7, inner)
            b_ms, b_by = bound(nbytes, nops)
            shapes.append({"shape": label, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
            how = "exact" if exact and compare is None else "same points"
            log(f"{name} {label}: {how}; kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
                f"plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by})")
        main_case = shapes[0]
        library_ms = None if library is None else cuda_ms(library, 7, inner=3 if big else 20)
        if library_ms is not None:
            log(f"{name} {main_case['shape']}: one PyTorch call computing it {library_ms:.4f} ms")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "counter": counter, "max_abs_err": max(s["max_abs_err"] for s in shapes),
                        "ms": main_case["ms"], "device_ms": main_case["device_ms"],
                        "plain_ms": main_case["plain_ms"],
                        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                        "library_ms": library_ms, "shapes": shapes})

    # -- 2. kernels against their plain versions at the path's shapes ----------
    n = BATCH * 4096
    b1 = []
    for spec, ops, width in ((FR, FR_MUL_OPS, n), (FQ, FQ_MUL_OPS, n), (FQ, FQ_MUL_OPS, 1 << 20)):
        a, b = field_operands(spec, width)
        b1.append((f"{spec.name} ({spec.nlimbs}, {width})",
                   lambda a=a, b=b, s=spec: fa.mont_mul_kernel(s, a, b),
                   lambda a=a, b=b, s=spec: fa.mont_mul_plain(s, a, b),
                   3 * spec.nlimbs * 4 * width, ops * width))
    check("mont_mul", "snarkos_tpu_torch/csrc/mont_mul.cu",
          "snarkos_tpu/ops/modarith.py:171", b1, fa.mont_mul_kernel)

    # B1's Fr passes. The permutation at the leaves' shape of both prove_batch
    # paths (B x 4096 lanes, rate 2) and at rate 4, with the edge states
    # (0, 1, p - 1 in every slot) in lanes 0-2
    def permute_case(rate, lanes):
        t = rate + 1
        st = torch.from_numpy(np.ascontiguousarray(
            FR.random(t * lanes, rng).reshape(FR.nlimbs, t, lanes).transpose(1, 0, 2))).to(dev)
        for lane, v in enumerate((0, 1, FR.p - 1)):
            st[:, :, lane] = torch.from_numpy(FR.encode_fast([v], mont=True)[:, 0]).to(dev)
        full, half = poseidon.FULL_ROUNDS, poseidon.PARTIAL_ROUNDS
        products = full * (5 * t + t * t) + half * (5 + t * t)  # s-boxes and the mix
        return (f"({t}, 16, {lanes})", lambda: poseidon.permute_kernel(st, rate),
                lambda: poseidon.permute_plain(st, rate),
                2 * t * 16 * 4 * lanes + poseidon.packed_consts(rate).numel() * 4,
                products * FR_MUL_OPS * lanes)

    check("fr_poseidon_permute", "snarkos_tpu_torch/csrc/mont_mul.cu",
          "snarkos_tpu/ops/modarith.py:171",
          [permute_case(2, BATCH * 4096), permute_case(2, BATCH_WIDE * 4096),
           permute_case(4, 4096)], poseidon.permute_kernel, big=True)

    # one step of the epoch program of the fixture's epoch at (16, B, 4096),
    # every selector present, edge leaves 0, 1, p - 1
    prog = puzzle_mod.EpochProgram(bytes.fromhex(fixture["epoch_hash"]), 4096, dev)

    def epoch_case(batch, step):
        v = torch.from_numpy(FR.random(batch * 4096, rng).reshape(FR.nlimbs, batch, 4096)).to(dev)
        v[:, 0, :3] = torch.from_numpy(FR.encode_fast([0, 1, FR.p - 1], mont=True)).to(dev)
        args = (v, prog.perms[step].contiguous(), prog.sels[step].reshape(-1).contiguous(),
                prog.consts[step].contiguous())
        counts = torch.bincount(args[2].long(), minlength=4).tolist()
        if min(counts) == 0:
            raise AssertionError(f"epoch step {step}: selectors {counts}, not all four present")
        lanes = batch * 4096
        return (f"(16, {batch}, 4096) step {step}", lambda: puzzle_mod.epoch_step_kernel(*args),
                lambda: puzzle_mod.epoch_step_plain(*args),
                (2 * 16 * lanes + 2 * 4096 + 16 * 4096) * 4,
                (lanes + batch * counts[3]) * FR_MUL_OPS)

    check("fr_epoch_step", "snarkos_tpu_torch/csrc/mont_mul.cu",
          "snarkos_tpu/ops/modarith.py:171",
          [epoch_case(BATCH, 0), epoch_case(BATCH_WIDE, 11)], puzzle_mod.epoch_step_kernel)

    def coords(p):
        return (p.x, p.y, p.z)

    # B2's add at the generic engine's widths: K = 4096 lanes (2^16 bases),
    # and 16 and 8 (batch_verify's padded MSMs with an identity base)
    b2 = []
    for width in (GENERIC_K, 16, 8):
        pa, pb, ops = point_pairs(width)
        b2.append((f"(24, {width})",
                   lambda pa=pa, pb=pb: coords(g1_kernels.add_kernel(pa, pb)),
                   lambda pa=pa, pb=pb: coords(g1.add(pa, pb)), 9 * 24 * 4 * width, ops))
    check("g1_add", "snarkos_tpu_torch/csrc/g1_add.cu", "snarkos_tpu/ops/g1_pallas.py:75",
          b2, g1_kernels.add_kernel)

    # B2's Horner step acc = 2^c acc + t at the windows' widths: acc an
    # identity with arbitrary X, Y in lane 0 (every MSM starts from one), and
    # 2^c acc == t, 2^c acc == -t in lanes 1, 2 (the add meets P == Q, P == -Q)
    def horner_case(width, c, identity_lane=True):
        acc = [rescale(multiples[prng.randrange(4096)]) for _ in range(width)]
        t = [rescale(multiples[prng.randrange(4096)]) for _ in range(width)]
        if identity_lane:
            acc[0] = (prng.randrange(FQ.p), prng.randrange(FQ.p), 0)
        for lane, sign in ((1, 1), (2, -1)):
            if lane < width:
                dbl = ref_g1.scalar_mul(1 << c, acc[lane])
                t[lane] = rescale(dbl if sign > 0 else ref_g1.neg(dbl))
        pa, pt = g1.encode_points(acc, dev), g1.encode_points(t, dev)
        doubled = [ref_g1.scalar_mul(1 << c, p) for p in acc]
        ops = 7 * c * sum(1 for p in acc if p[2]) * FQ_MUL_OPS
        if width >= 3:
            ops += add_ops(doubled, t)
        else:
            ops += sum(16 * FQ_MUL_OPS for p, q in zip(doubled, t) if p[2] and q[2])
        label = f"(24, {width}) c={c}" + ("" if identity_lane or width > 1 else ", acc finite")
        return (label, lambda: coords(g1_kernels.horner_kernel(pa, pt, c)),
                lambda: coords(g1_kernels.horner_plain(pa, pt, c)), 9 * 24 * 4 * width, ops)

    check("g1_horner", "snarkos_tpu_torch/csrc/g1_add.cu", "snarkos_tpu/ops/g1_pallas.py:75",
          [horner_case(8, 6), horner_case(16, 6), horner_case(1, 14, identity_lane=False),
           horner_case(1, 14)], g1_kernels.horner_kernel)

    # B2's bucket fixup at the three paths' widths: B_total buckets over the
    # scan outputs of m K positions and the carries of KV chains (b8: serial
    # chains, 2^15 positions, 256 chains; b16: 2^16, 2048; 2^20: 2^20, 4096).
    # The values come from a pool of rescaled points, their rescaled copies
    # and negations, and identities with arbitrary X, Y; every fourth bucket
    # that takes a carry meets P == Q or P == -Q.
    pool_pts = [rescale(multiples[prng.randrange(4096)]) for _ in range(1024)]
    pool_pts[7::64] = [(prng.randrange(FQ.p), prng.randrange(FQ.p), 0)] * len(pool_pts[7::64])
    pool_pts += [rescale(p) for p in pool_pts[:1024]] + [rescale(ref_g1.neg(p))
                                                         for p in pool_pts[:1024]]
    pool = g1.encode_points(pool_pts, dev)

    def fixup_case(nb, ns, nc):
        g = torch.Generator().manual_seed(nb)
        tail_src = torch.randint(0, 1024, (ns,), generator=g)
        carry_src = torch.randint(0, 3072, (nc,), generator=g)
        flat = torch.randint(0, ns, (nb,), generator=g)
        chain_of = torch.randint(0, nc, (nb,), generator=g)
        needs = torch.rand(nb, generator=g) < 0.3
        live = (torch.rand(nb, generator=g) < 0.95) & (torch.arange(nb) > 0)
        takers = (needs & live).nonzero().reshape(-1)[::4]
        for i, b in enumerate(takers.tolist()):  # P == Q, P == -Q
            carry_src[chain_of[b]] = tail_src[flat[b]] + (1024 if i % 2 == 0 else 2048)
        scan = tuple(t[:, tail_src.to(dev)].contiguous() for t in coords(pool))
        carry = tuple(t[:, carry_src.to(dev)].contiguous() for t in coords(pool))
        args = (scan, flat.to(dev), carry, chain_of.to(dev), needs.to(dev), live.to(dev))
        tails = [pool_pts[int(tail_src[f])] for f in flat.tolist()]
        carries = [pool_pts[int(carry_src[k])] for k in chain_of.tolist()]
        adds = [(p, q) for p, q, a in zip(tails, carries, (needs & live).tolist()) if a]
        nbytes = (3 * 24 * 4 * (int(live.sum()) + len(adds) + nb) + 18 * nb)
        return (f"(24, {nb}) of ({ns}, {nc})",
                lambda: coords(g1_kernels.bucket_fixup_kernel(*args)),
                lambda: coords(g1_kernels.bucket_fixup_plain(*args)), nbytes,
                add_ops([p for p, _ in adds], [q for _, q in adds]))

    check("g1_bucket_fixup", "snarkos_tpu_torch/csrc/g1_add.cu",
          "snarkos_tpu/ops/g1_pallas.py:75",
          [fixup_case(BATCH * 33, BATCH * 4096, 256), fixup_case(BATCH_WIDE * 33, 1 << 16, 2048),
           fixup_case((1 << 13) + 1, 1 << LOG_N, 4096)], g1_kernels.bucket_fixup_kernel)

    # a real window of the batch-8 multi-MSM: base = 4096 affine points tiled
    # 8 times, random scalars, c = 6, K = 256 chains of m = 128
    base = g1.encode_points(multiples, dev)
    c = msm.fused_window_bits(4096)
    B = (1 << (c - 1)) + 1

    def multi_window(batch, serial):
        """Chain layout of the middle window of a batch-``batch`` multi-MSM
        over ``base`` with random scalars, with edge steps P == Q and P == -Q
        inside chains 0-7 (each a head, then its copy or its negation); on
        serial chains also across the sub-run boundaries s-1 | s of B4's
        teams, s = 1, 2, 4, 8 (chains 8-23)."""
        nn = batch * 4096
        K = msm._default_lanes(nn)
        x = base.x.repeat(1, batch)
        ycat = torch.cat([base.y.repeat(1, batch), fa.neg(FQ, base.y).repeat(1, batch)], dim=-1)
        packed = msm.signed_window_digits(torch.from_numpy(FR.random(nn, rng)).to(dev), c)
        src = msm.chain_src(nn, K, msm_kernels.CHUNK, serial, dev)
        batch_off = (torch.arange(nn, device=dev) // 4096) * B
        _, xs, ys, heads = msm.chain_layout(x, ycat, packed[packed.shape[0] // 2], src, batch_off)
        rows = 1 if serial else msm_kernels.CHUNK
        j0, j1 = 4 * rows, 5 * rows  # steps 4 and 5 of the chains in layout row 0
        xs, ys, heads = xs.clone(), ys.clone(), heads.clone()
        edges = [(k, j0, j1) for k in range(8)]
        if serial:
            edges += [(8 + 4 * i + r, s - 1, s) for i, s in enumerate((1, 2, 4, 8)) for r in range(4)]
        for k, a, b in edges:
            xs[:, b, k], ys[:, b, k], heads[a, k], heads[b, k] = xs[:, a, k], ys[:, a, k], 1, 0
            if k % 2:
                ys[:, b, k] = fa.neg(FQ, ys[:, a, k:k + 1])[:, 0]
        return xs, ys, heads.unsqueeze(0).contiguous(), K

    def scan_cost(flags, n_dbl):
        """(bytes, multiplies) of a bucket scan: affine inputs and head flags
        read, Jacobian outputs written; 11 Fq products a non-head step, 6
        more for a doubling."""
        npos = flags.numel()
        return ((2 * 24 * 4 + 4 + 3 * 24 * 4) * npos,
                ((npos - int(flags.sum())) * 11 + 6 * n_dbl) * FQ_MUL_OPS)

    # B4 on windows of the batch-8 and batch-1 multi-MSMs, each of the team
    # sizes of the sweep at batch 8 (the path's team first); 12 doublings:
    # the even edge chains
    xs, ys, flags, K = multi_window(BATCH, serial=True)
    m = xs.shape[1]
    xs1, ys1, fl1, K1 = multi_window(1, serial=True)
    m1 = xs1.shape[1]
    team = msm_kernels.SERIAL_TEAM

    def plain8():
        return msm_kernels.bucket_scan_serial_plain(xs, ys, flags)

    b4 = [(f"(24, {m}, {K}) T={t}",
           lambda t=t: msm_kernels.bucket_scan_serial_kernel(xs, ys, flags, team=t),
           plain8, *scan_cost(flags, 12))
          for t in [team] + [t for t in TEAM_SWEEP if t != team]]
    b4.append((f"(24, {m1}, {K1}) T={min(team, m1)}",
               lambda: msm_kernels.bucket_scan_serial_kernel(xs1, ys1, fl1),
               lambda: msm_kernels.bucket_scan_serial_plain(xs1, ys1, fl1), *scan_cost(fl1, 12)))
    check("bucket_scan_serial", "snarkos_tpu_torch/csrc/bucket_scan_serial.cu",
          "snarkos_tpu/ops/msm_pallas.py:265", b4, msm_kernels.bucket_scan_serial_kernel,
          exact=False)

    # the 2^20 single MSM's bases (the dev SRS powers, tau^i known) and scalars
    N = 1 << LOG_N
    bx, by = srs.points.x[:, :N].contiguous(), srs.points.y[:, :N].contiguous()
    big_scalars = torch.from_numpy(FR.random(N, np.random.default_rng(20))).to(dev)
    c20 = msm.fused_window_bits(N)
    K20 = msm._default_lanes(N)
    src20 = msm.chain_src(N, K20, msm_kernels.CHUNK, False, dev)
    packed20 = msm.signed_window_digits(big_scalars, c20)
    keys20, xs20, ys20, heads20 = msm.chain_layout(
        bx, torch.cat([by, fa.neg(FQ, by)], dim=-1), packed20[packed20.shape[0] // 2], src20)
    fl20 = heads20.unsqueeze(0).contiguous()
    m20 = xs20.shape[1]

    # a window of the batch-16 multi-MSM (B3's widths, B5)
    xs16, ys16, fl16, K16 = multi_window(BATCH_WIDE, serial=False)

    # B3 at the seven prefix widths of the paths, with their head flags: the
    # cross-chain carries (one flag per chain: any head in it) and the
    # bucket suffix scans (per-batch segments of B buckets, or none)
    def chain_heads(fl, rows):
        return fl.reshape(-1, rows, fl.shape[-1]).max(0).values.reshape(-1)

    def batch_heads(batch):
        return (torch.arange(batch * B, device=dev) % B == 0).to(torch.int32)

    def prefix_case(width, fl):
        """Random rescaled points, identities with arbitrary X, Y at every
        16th lane, and at lanes 2-15 (and again from width / 2) the edges
        where round 0 meets P == Q and P == -Q and round 1 (distance 2)
        meets (A + B) + (A + B) and (A + B) + (-A - B)."""
        pts = [rescale(multiples[prng.randrange(4096)]) for _ in range(width)]
        heads = [int(v) for v in fl.reshape(-1).tolist()]
        for e in range(7, width, 16):
            pts[e] = (prng.randrange(FQ.p), prng.randrange(FQ.p), 0)
        for base in sorted({0, width // 2 if width >= 64 else 0}):
            A, Bp = multiples[prng.randrange(4096)], multiples[prng.randrange(4096)]
            block = {3: A, 4: A, 5: Bp, 6: ref_g1.neg(Bp), 8: A, 9: Bp, 10: A, 11: Bp,
                     12: A, 13: Bp, 14: ref_g1.neg(A), 15: ref_g1.neg(Bp)}
            for off, pt in block.items():
                pts[base + off] = rescale(pt)
                heads[base + off] = int(off in (3, 5, 8, 12))
        enc = g1.encode_points(pts, dev)
        state = (torch.tensor([heads], dtype=torch.int32, device=dev), enc.x, enc.y, enc.z)
        n_add = sum(1 for h in heads[1:] if not h)  # a sequential scan's additions
        return (f"(24, {width})", lambda: g1_kernels.seg_prefix_kernel(*state),
                lambda: g1_kernels.seg_prefix_plain(state),
                2 * (1 + 3 * 24) * 4 * width, 16 * n_add * FQ_MUL_OPS)

    kv20 = msm_kernels.CHUNK * K20

    def zeros(w):
        return torch.zeros(w, dtype=torch.int32, device=dev)

    check("seg_prefix", "snarkos_tpu_torch/csrc/seg_prefix.cu",
          "snarkos_tpu/ops/g1_pallas.py:125",
          [prefix_case(K, chain_heads(flags, 1)), prefix_case(BATCH * B, batch_heads(BATCH)),
           prefix_case(msm_kernels.CHUNK * K16, chain_heads(fl16, msm_kernels.CHUNK)),
           prefix_case(BATCH_WIDE * B, batch_heads(BATCH_WIDE)),
           prefix_case(kv20, chain_heads(fl20, msm_kernels.CHUNK)),
           prefix_case(K1, chain_heads(fl1, 1)), prefix_case(B, zeros(B)),
           prefix_case(GENERIC_K, torch.from_numpy((rng.random(GENERIC_K) < 0.05)
                                                   .astype(np.int32)).to(dev)),
           prefix_case(16, zeros(16))],
          g1_kernels.seg_prefix_kernel)

    # Edge steps for the wide scans B5 and B6 (element i of chain (r, k) a
    # head, i + 1 its copy or its negation): mid-chain (10 | 11), on both
    # sides of every sub-run boundary of the team sweep (s - 2 | s - 1: the
    # last step of member 0; s - 1 | s: the first step of member 1, from its
    # carry) and at the chain start (element 0 no head, element 1 its copy or
    # negation), two chains each (P == Q, P == -Q).
    chunk = msm_kernels.CHUNK

    def edge_steps(mv):
        return [10, 0] + sorted({s + d for t in WIDE_TEAM_SWEEP for s in [-(-mv // t)]
                                 for d in (-2, -1)} & set(range(1, mv - 1)))

    def edge_chains(steps):
        return [((0, 3, 7)[i % 3], 100 + 3 * i) for i in range(2 * len(steps))]

    def plant_edges(xs, ys, fl, edges):
        """Copies of the chain layout with the edge steps (r, k, i) planted;
        odd entries of ``edges`` negate."""
        xs, ys, fl = xs.clone(), ys.clone(), fl.clone()
        for idx, (r, k, i) in enumerate(edges):
            j0, j1 = i * chunk + r, (i + 1) * chunk + r
            xs[:, j1, k], ys[:, j1, k], fl[0, j0, k], fl[0, j1, k] = xs[:, j0, k], ys[:, j0, k], 1, 0
            if i == 0:
                fl[0, j0, k] = 0  # the chain starts mid-segment
            if idx % 2:
                ys[:, j1, k] = fa.neg(FQ, ys[:, j0, k:k + 1])[:, 0]
        return xs, ys, fl

    # B6 on the 2^20 window with the edge steps in live buckets, where
    # exactly those chains must flag, and in bucket 0 (the first ~64 sorted
    # positions, all in chain 0), where the flag must stay clear.
    nz20 = (keys20 > 0).to(torch.int32)[src20.reshape(-1)].reshape(1, m20, K20).contiguous()
    mv20 = m20 // chunk
    steps = edge_steps(mv20)
    live_chains = edge_chains(steps)
    edges = [(r, k, steps[idx // 2]) for idx, (r, k) in enumerate(live_chains)]
    edges += [(0, 0, 10), (0, 0, 20), (0, 0, 15), (0, 0, 31)]
    xs6, ys6, fl6 = plant_edges(xs20, ys20, fl20, edges)
    for r, k, i in edges:
        j0, j1 = i * chunk + r, (i + 1) * chunk + r
        live = (r, k) in live_chains
        if int(nz20[0, j0, k]) != live or int(nz20[0, j1, k]) != live:
            raise AssertionError(f"B6 edge step at chain ({r}, {k}) is not where it was meant")
    want_exc = torch.zeros((1, chunk, K20), dtype=torch.int32, device=dev)
    for r, k in live_chains:
        want_exc[0, r, k] = 1
    log(f"B6 edge steps at elements {steps} (live, {len(live_chains)} chains) and "
        "10, 20, 15, 31 (bucket 0)")

    def exc_exact(label, got):
        if not torch.equal(got[3], want_exc):
            raise AssertionError(f"bucket_scan_fast {label}: exc set in chains "
                                 f"{got[3].nonzero().tolist()}, want {live_chains}")
        log(f"bucket_scan_fast {label}: exc set in exactly the {len(live_chains)} edge chains")

    def b6_compare(got, want):
        """exc exactly; the same points at every position of a live bucket
        in an unflagged chain (chain of flat position e: e % KV)."""
        if not torch.equal(got[3], want[3]):
            raise AssertionError("bucket_scan_fast: exc differs from the plain version's")
        flagged = want[3].reshape(-1)[torch.arange(m20 * K20, device=dev) % (chunk * K20)]
        mask = (nz20.reshape(-1) != 0) & (flagged == 0)
        return affine_err(got[:3], want[:3], mask)

    def plain6():
        return msm_kernels.bucket_scan_fast_plain(xs6, ys6, fl6, nz20, chunk)

    b6_bytes, b6_ops = scan_cost(fl6, 0)  # plus the nonzero flags read, exc written
    team6 = msm_kernels.FAST_TEAM
    check("bucket_scan_fast", "snarkos_tpu_torch/csrc/bucket_scan_fast.cu",
          "snarkos_tpu/ops/msm_pallas.py:138",
          [(f"(24, {m20}, {K20}) T={t}",
            lambda t=t: msm_kernels.bucket_scan_fast_kernel(xs6, ys6, fl6, nz20, chunk, team=t),
            plain6, b6_bytes + 4 * m20 * K20 + 4 * chunk * K20, b6_ops)
           for t in [team6] + [t for t in WIDE_TEAM_SWEEP if t != team6]],
          msm_kernels.bucket_scan_fast_kernel, big=True, verify=exc_exact, compare=b6_compare)

    # B5 on the batch-16 window with the edge steps planted, and on B6's 2^20
    # window (its edges in live buckets and in bucket 0), at each team size of
    # the sweep (the path's first): the same points at every position
    mv16 = xs16.shape[1] // chunk
    steps16 = edge_steps(mv16)
    xs5, ys5, fl5 = plant_edges(xs16, ys16, fl16, [
        (r, k, steps16[idx // 2]) for idx, (r, k) in enumerate(edge_chains(steps16))])
    n_dbl16 = 4 + len(steps16)  # the doublings: multi_window's 4 and one a step here
    team5 = msm_kernels.SCAN_TEAM
    sweep5 = [team5] + [t for t in WIDE_TEAM_SWEEP if t != team5]
    log(f"B5 edge steps at elements {steps16} (batch 16) and {steps} (2^20)")

    def plain5_16():
        return msm_kernels.bucket_scan_plain(xs5, ys5, fl5, chunk)

    def plain5_20():
        return msm_kernels.bucket_scan_plain(xs6, ys6, fl6, chunk)

    check("bucket_scan", "snarkos_tpu_torch/csrc/bucket_scan.cu",
          "snarkos_tpu/ops/msm_pallas.py:173",
          [(f"(24, {xs5.shape[1]}, {K16}) T={t}",
            lambda t=t: msm_kernels.bucket_scan_kernel(xs5, ys5, fl5, chunk, team=t),
            plain5_16, *scan_cost(fl5, n_dbl16)) for t in sweep5]
          + [(f"(24, {m20}, {K20}) T={t}",
              lambda t=t: msm_kernels.bucket_scan_kernel(xs6, ys6, fl6, chunk, team=t),
              plain5_20, *scan_cost(fl6, len(steps) + 2)) for t in sweep5],
          msm_kernels.bucket_scan_kernel, big=True, exact=False)

    # B7, the weighted bucket total of a window, at the 2^20 MSM's B = 2^13 +
    # 1 (the path's setting first, without the suffixes, as the path calls
    # it; then the sweep, each with every suffix) and at the c = 16 MSM's B =
    # 2^15 + 1. The kernel reads the live buckets in reverse, element r =
    # bucket B - 1 - r; at the thread and block boundaries of every setting
    # (r = k s, r = k T s) the planted pairs give P == Q and P == -Q across the
    # boundary, and identities (arbitrary X, Y) sit on both sides of another;
    # elements 0 and 1 cancel (a suffix is the identity). Then an
    # all-identity input (T_w is the identity).
    def total_case(B, sweep):
        pts = [rescale(multiples[prng.randrange(4096)]) for _ in range(B)]

        def at(r):
            return B - 1 - r

        def pair(r, neg):
            if 0 < r < B - 1:
                q = pts[at(r - 1)]
                pts[at(r)] = rescale(ref_g1.neg(q) if neg else q) if q[2] else q

        for T, s_ in sweep:
            for k, bound in enumerate((s_, 2 * s_, T * s_, 2 * T * s_)):
                pair(bound, k % 2 == 1)
            for bound in (3 * s_, 3 * T * s_):
                for r in (bound - 1, bound):
                    if r < B - 1:
                        pts[at(r)] = (prng.randrange(FQ.p), prng.randrange(FQ.p), 0)
        pts[at(1)] = rescale(ref_g1.neg(pts[at(0)]))
        p = g1.encode_points(pts, dev)
        n_fin = sum(1 for q in pts[1:] if q[2])
        return (p.x, p.y, p.z), n_fin

    def total_bound(B, n_fin, suffixes):
        """Buckets read once, T_w (and the suffixes) written once; the 2 n_fin
        complete adds of a serial scan and total (16 Fq products each)."""
        return 3 * 24 * 4 * (B + 1 + (B if suffixes else 0)), 2 * n_fin * 16 * FQ_MUL_OPS

    def b7_compare(got, want):
        """T_w the same point; with the suffixes (a kernel run with scan_out),
        every suffix the same point too."""
        if len(got) == 2:
            return max(affine_err(got[0], want[0]), affine_err(got[1], want[1]))
        return affine_err(got, want[0])

    b7 = []
    for B7, sweep in (((1 << 13) + 1, TOTAL_SWEEP), ((1 << 15) + 1, TOTAL_SWEEP_WIDE)):
        sums7, n_fin7 = total_case(B7, sweep)

        def plain7(sums7=sums7):
            return msm_kernels.bucket_total_plain(*sums7)

        if B7 == (1 << 13) + 1:
            b7.append((f"(24, {B7}) T={msm_kernels.BUCKET_THREADS} "
                       f"s={msm_kernels.BUCKET_PER_THREAD}, path",
                       lambda sums7=sums7: msm_kernels.bucket_total_kernel(*sums7), plain7,
                       *total_bound(B7, n_fin7, False)))
        b7 += [(f"(24, {B7}) T={t} s={s_}, suffixes",
                lambda sums7=sums7, t=t, s_=s_: msm_kernels.bucket_total_kernel(
                    *sums7, threads=t, per_thread=s_, scan_out=True),
                plain7, *total_bound(B7, n_fin7, True)) for t, s_ in sweep]
    # the generic engine's B = 2^c: bucket 0 holds a point the total ignores
    for B7 in (1 << GENERIC_C, 16):
        sums7, n_fin7 = total_case(B7, ((msm_kernels.BUCKET_THREADS, 1),))
        b7.append((f"(24, {B7}) generic",
                   lambda sums7=sums7: msm_kernels.bucket_total_kernel(*sums7),
                   lambda sums7=sums7: msm_kernels.bucket_total_plain(*sums7),
                   *total_bound(B7, n_fin7, False)))
    ids7 = g1.encode_points([(prng.randrange(FQ.p), prng.randrange(FQ.p), 0)
                             for _ in range((1 << 13) + 1)], dev)
    ids7 = (ids7.x, ids7.y, ids7.z)

    def no_total(label, got):
        if "identities" in label and int(got[0][2].abs().sum()) != 0:
            raise AssertionError(f"jadd_bucket_total {label}: T_w is not the identity")

    b7.append((f"(24, {(1 << 13) + 1}) all identities, suffixes",
               lambda: msm_kernels.bucket_total_kernel(*ids7, scan_out=True),
               lambda: msm_kernels.bucket_total_plain(*ids7), *total_bound((1 << 13) + 1, 0, True)))
    check("jadd_bucket_total", "snarkos_tpu_torch/csrc/jadd_scan.cu",
          "snarkos_tpu/ops/msm_pallas.py:303", b7, msm_kernels.bucket_total_kernel,
          compare=b7_compare, verify=no_total)

    def run_path(label, fn, required, absent=(), exact=None, at_most=None):
        """Drive one path with every launch counter at 0 just before it; the
        kernels in ``required`` must launch, those in ``absent`` must not,
        those in ``exact`` exactly as often as it says, those in ``at_most``
        no more often."""
        torch.cuda.synchronize()
        for kern in kernels:
            kern["counter"].launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {kern["name"]: kern["counter"].launches for kern in kernels}
        for kern in kernels:
            kern.setdefault("launches_per_path", {})[label] = counts[kern["name"]]
        log(f"launches in {label}: " + ", ".join(f"{k} {v}" for k, v in counts.items())
            + f"; B2 in all {sum(counts[k] for k in ('g1_add', 'g1_horner', 'g1_bucket_fixup'))}")
        missing = [k for k in required if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched in {label}: {missing}")
        extra = [k for k in absent if counts[k] != 0]
        if extra:
            raise AssertionError(f"kernels launched in {label} that must not be: {extra}")
        off = {k: counts[k] for k, v in (exact or {}).items() if counts[k] != v}
        off.update({k: counts[k] for k, v in (at_most or {}).items() if counts[k] > v})
        if off:
            raise AssertionError(f"launches in {label}: {off}, want {exact} and at most {at_most}")
        return out

    # -- 3. the prover at batch 8 ---------------------------------------------------
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
    sols = run_path(f"prove_batch({BATCH})", lambda: puzzle.prove_batch(epoch, address, nonces),
                    ["mont_mul", "fr_poseidon_permute", "fr_epoch_step", "g1_horner",
                     "g1_bucket_fixup", "seg_prefix", "bucket_scan_serial"],
                    absent=["g1_add", "jadd_bucket_total"],
                    exact=PATH_LAUNCHES, at_most={"mont_mul": MONT_MUL_MAX})

    if len(sols) != len(nonces):
        raise AssertionError(f"{len(sols)} solutions for {len(nonces)} nonces")
    for row, sol in zip(fixture["solutions"], sols):
        got = (sol.commitment.hex(), str(sol.eval_y), sol.witness.hex(), str(sol.solution_id))
        want = (row["commitment"], row["eval_y"], row["witness"], row["solution_id"])
        if got != want:
            raise AssertionError(f"nonce {row['nonce']}: solution differs from the fixture")
    log("prove_batch(8) matches tests/fixtures/torch_puzzle_k12_b8.json byte for byte")

    def host_check(batch_nonces, batch_sols):
        """C = p(tau) G, W = q(tau) G, y = p(z) and solution_id = sha64(C || y),
        from the coefficients on the host."""
        coeffs = puzzle.coefficients(epoch, address, batch_nonces)
        r = params.FR_MODULUS
        for i, sol in enumerate(batch_sols):
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
                raise AssertionError(f"nonce {batch_nonces[i]}: C != p(tau) G or W != q(tau) G")
            if sha64(sol.commitment, y.to_bytes(32, "little")) != sol.solution_id:
                raise AssertionError(f"nonce {batch_nonces[i]}: solution_id != sha64(C || y)")
        log(f"C = p(tau) G, W = q(tau) G and solution_id = sha64(C || y) hold for all "
            f"{len(batch_sols)} nonces")

    host_check(nonces, sols)
    one = puzzle.prove_batch(epoch, address, [nonces[5]])
    if len(one) != 1 or one[0] != sols[5]:
        raise AssertionError("prove_batch of one nonce differs from the batch of eight")
    log("prove_batch(1) == prove_batch(8)[5]")

    def solutions_per_s(batch_nonces):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            puzzle.prove_batch(epoch, address, batch_nonces)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        log(f"prove_batch({len(batch_nonces)}): median {med:.3f} s of "
            f"{[round(t, 3) for t in times]} -> {len(batch_nonces) / med:.3f} solutions/s on {smi}")
        return times, len(batch_nonces) / med

    times8, sps8 = solutions_per_s(nonces)
    report.update(srs_build_s=srs_s, prove_batch8_s=times8, solutions_per_s=sps8)

    # -- 4. the prover at batch 16: the wide-chain engine (B5) ---------------------
    nonces16 = list(range(BATCH_WIDE))
    if nonces16[:BATCH] != nonces:
        raise AssertionError("the fixture's nonces are not 0-7")
    puzzle.prove_batch(epoch, address, nonces16)  # warm-up
    sols16 = run_path(f"prove_batch({BATCH_WIDE})",
                      lambda: puzzle.prove_batch(epoch, address, nonces16),
                      ["mont_mul", "fr_poseidon_permute", "fr_epoch_step", "g1_horner",
                       "g1_bucket_fixup", "seg_prefix", "bucket_scan"],
                      absent=["bucket_scan_serial", "g1_add", "jadd_bucket_total"],
                      exact=PATH_LAUNCHES,
                      at_most={"mont_mul": MONT_MUL_MAX})
    if len(sols16) != BATCH_WIDE or sols16[:BATCH] != sols:
        raise AssertionError("prove_batch(16)[:8] differs from prove_batch(8) (and the fixture)")
    log("prove_batch(16)[:8] == prove_batch(8), byte for byte equal to the fixture")
    host_check(nonces16, sols16)
    times16, sps16 = solutions_per_s(nonces16)
    report.update(prove_batch16_s=times16, solutions_per_s_b16=sps16)

    # -- 5. the 2^20 single MSM: fast engine (B6), bucket total (B7), rerun (B5) ------
    r = params.FR_MODULUS
    ks = FR.decode_fast(big_scalars.cpu().numpy())

    s_tau, tau_i = 0, 1  # sum k_i tau^i, the discrete log of the MSM
    for k in ks:
        s_tau = (s_tau + k * tau_i) % r
        tau_i = tau_i * DEV_TAU % r

    def times_g(s):
        return ref_g1.affine(ref_g1.scalar_mul(s % r, ref_g1.GENERATOR))

    def affine_of(out):
        return ref_g1.affine(g1.decode_points(out)[0])

    W20 = packed20.shape[0]
    got = run_path(f"msm_affine(2^{LOG_N})", lambda: msm.msm_affine(bx, by, big_scalars),
                   ["bucket_scan_fast", "jadd_bucket_total", "g1_horner", "g1_bucket_fixup",
                    "seg_prefix"],
                   absent=["bucket_scan", "bucket_scan_serial"],
                   exact={"jadd_bucket_total": W20, "seg_prefix": W20, "g1_add": 0})
    if affine_of(got) != times_g(s_tau):
        raise AssertionError(f"msm_affine(2^{LOG_N}) != (sum k_i tau^i) G")
    log(f"msm_affine(2^{LOG_N}) == (sum k_i tau^i) G on the fast engine")

    bx2, by2, sc2 = bx.clone(), by.clone(), big_scalars.clone()
    bx2[:, 1], by2[:, 1], sc2[:, 1] = bx[:, 0], by[:, 0], big_scalars[:, 0]
    got = run_path(f"msm_affine(2^{LOG_N}, base 1 = base 0)",
                   lambda: msm.msm_affine(bx2, by2, sc2),
                   ["bucket_scan_fast", "bucket_scan", "jadd_bucket_total", "g1_horner",
                    "g1_bucket_fixup"],
                   exact={"jadd_bucket_total": 2 * W20, "seg_prefix": 2 * W20, "g1_add": 0})
    # base 1 (tau G) and k_1 gave way to base 0 (G) and k_0
    if affine_of(got) != times_g(s_tau - ks[1] * DEV_TAU + ks[0]):
        raise AssertionError(f"msm_affine(2^{LOG_N}) with base 1 = base 0 is wrong after the rerun")
    log(f"msm_affine(2^{LOG_N}) with base 1 = base 0: the flag fired, the complete engine "
        "reran, and the result == (sum k_i tau^i) G")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        msm.msm_affine(bx, by, big_scalars)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"msm_affine(2^{LOG_N}): median {med:.3f} s of {[round(t, 3) for t in times]} -> "
        f"{N / med:.0f} points/s on {smi}")
    report.update(msm_s=times, msm_points_per_s=N / med)

    # -- 6. the generic engine: 2^16 Jacobian bases (B2's add, B3, B7, B2's horner) ---
    NG = 1 << LOG_GENERIC
    gen_pts = [rescale(p) for p in srs.srs_ref.powers_g1[:NG]]  # z != 1
    for i in range(0, NG, 64):  # every 64th an identity
        gen_pts[i] = ref_g1.INFINITY
    gen_scalars = FR.random(NG, np.random.default_rng(16))
    gen_scalars[:, ::97] = 0
    gen_base = g1.encode_points(gen_pts, dev)
    gen_k = torch.from_numpy(gen_scalars).to(dev)
    ks_g = FR.decode_fast(gen_scalars)
    s_gen, tau_i = 0, 1  # sum over the non-identity lanes of k_i tau^i
    for i, k in enumerate(ks_g):
        if gen_pts[i][2]:
            s_gen = (s_gen + k * tau_i) % r
        tau_i = tau_i * DEV_TAU % r
    if msm.default_window_bits(NG) != GENERIC_C:
        raise AssertionError(f"default_window_bits(2^{LOG_GENERIC}) != {GENERIC_C}")
    W_g = -(-msm.SCALAR_BITS // GENERIC_C)
    m_g = NG // GENERIC_K
    # a window: 2 passes of m steps of B2's add at width K, one B3 prefix of
    # the lane aggregates, one B7 total of the 2^c buckets, one Horner step
    got = run_path(f"msm(2^{LOG_GENERIC}, Jacobian bases)", lambda: msm.msm(gen_base, gen_k),
                   ["g1_add", "seg_prefix", "jadd_bucket_total", "g1_horner"],
                   absent=["bucket_scan_serial", "bucket_scan", "bucket_scan_fast"],
                   exact={"g1_add": 2 * m_g * W_g, "seg_prefix": W_g,
                          "jadd_bucket_total": W_g, "g1_horner": W_g, "g1_bucket_fixup": 0})
    if affine_of(got) != times_g(s_gen):
        raise AssertionError(f"msm(2^{LOG_GENERIC}) on Jacobian bases != "
                             "(sum k_i tau^i) G over the non-identity lanes")
    log(f"msm(2^{LOG_GENERIC}) on Jacobian bases (z != 1, every 64th an identity, every 97th "
        f"scalar 0) == (sum k_i tau^i) G: generic engine, W = {W_g}, m = {m_g}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        msm.msm(gen_base, gen_k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"msm(2^{LOG_GENERIC}) generic: median {med:.3f} s of {[round(t, 3) for t in times]} "
        f"-> {NG / med:.0f} points/s on {smi}")
    report.update(generic_msm_s=times, generic_points_per_s=NG / med)

    # -- 7. the verifier: a block's solutions ---------------------------------------
    items = [(epoch, address, n, sol.commitment, sol.eval_y, sol.witness, 1)
             for n, sol in zip(nonces[:VERIFY_BATCH], sols[:VERIFY_BATCH])]
    b1_per_binding = dict(PATH_LAUNCHES)
    ok = run_path("check_binding", lambda: puzzle.check_binding(*items[0][:5]),
                  ["fr_poseidon_permute", "fr_epoch_step", "mont_mul"],
                  absent=["g1_add", "bucket_scan_serial", "seg_prefix"],
                  exact=b1_per_binding, at_most={"mont_mul": MONT_MUL_MAX})
    if not ok:
        raise AssertionError("check_binding rejected a solution of prove_batch")
    ok = run_path(f"verify_batch({VERIFY_BATCH})", lambda: puzzle.verify_batch(items),
                  ["fr_poseidon_permute", "fr_epoch_step", "bucket_scan_serial", "seg_prefix",
                   "g1_bucket_fixup", "g1_horner"],
                  absent=["g1_add", "bucket_scan", "bucket_scan_fast", "jadd_bucket_total"],
                  exact={k: VERIFY_BATCH * v for k, v in b1_per_binding.items()})
    if not ok:
        raise AssertionError(f"verify_batch({VERIFY_BATCH}) rejected prove_batch's solutions")
    for item in items:
        if not puzzle.verify(*item):
            raise AssertionError(f"verify rejected the solution of nonce {item[2]}")
    log(f"verify_batch({VERIFY_BATCH}) and verify of each accept prove_batch's solutions")
    bumped = items[:2] + [items[2][:4] + ((items[2][4] + 1) % r,) + items[2][5:]] + items[3:]
    swapped = [items[0][:5] + (items[1][5], 1), items[1][:5] + (items[0][5], 1)] + items[2:]
    if puzzle.verify_batch(bumped) or puzzle.verify_batch(swapped):
        raise AssertionError("verify_batch accepted eval_y + 1 or swapped witnesses")
    q = params.FQ_MODULUS
    if puzzle.check_structural(q.to_bytes(48, "little") + items[0][3][48:], *items[0][4:7]) \
            is not None:
        raise AssertionError("check_structural accepted an x >= q encoding")
    log("verify_batch rejects eval_y + 1 and swapped witnesses; check_structural rejects x >= q")

    openings = [puzzle.check_structural(*it[3:7]) for it in items]
    k_const = prng.randrange(1, r)
    const = (ref_g1.scalar_mul(k_const, ref_g1.GENERATOR), prng.randrange(1, r), k_const,
             ref_g1.INFINITY)  # p(X) = k: C = k G, W = the identity
    srs_ref = puzzle.srs.srs_ref
    fused_ok = run_path(f"batch_verify({VERIFY_BATCH} affine)",
                        lambda: kzg.batch_verify(srs_ref, openings),
                        ["bucket_scan_serial", "seg_prefix", "g1_horner"],
                        absent=["g1_add", "jadd_bucket_total"])
    gen_ok = run_path(f"batch_verify({VERIFY_BATCH} + identity witness)",
                      lambda: kzg.batch_verify(srs_ref, openings + [const]),
                      ["g1_add", "seg_prefix", "jadd_bucket_total", "g1_horner"],
                      absent=["bucket_scan_serial", "g1_bucket_fixup"])
    const_bad = (const[0], const[1], (const[2] + 1) % r, const[3])
    if not (fused_ok and gen_ok) or kzg.batch_verify(srs_ref, openings + [const_bad]):
        raise AssertionError("batch_verify: the fused or generic engine gave a wrong verdict")
    log("batch_verify: the fused engine without the identity witness, the generic one with "
        "it; both accept, and reject once the constant opening's y changes")

    def med3(fn):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts), ts

    gamma = pow(5, 8, r)
    left, acc_w, g_i = ref_g1.INFINITY, ref_g1.INFINITY, 1
    for c_pt, z, y, w_pt in openings:  # the two points batch_verify pairs
        term = ref_g1.add(ref_g1.add(c_pt, ref_g1.neg(ref_g1.scalar_mul(y, ref_g1.GENERATOR))),
                          ref_g1.scalar_mul(z, w_pt))
        left = ref_g1.add(left, ref_g1.scalar_mul(g_i, term))
        acc_w = ref_g1.add(acc_w, ref_g1.scalar_mul(g_i, w_pt))
        g_i = g_i * gamma % r
    pairs = [(ref_g1.affine(left), srs_ref.h), (ref_g1.affine(ref_g1.neg(acc_w)), srs_ref.tau_h)]
    vb_s, vb_all = med3(lambda: puzzle.verify_batch(items))
    bind_s, _ = med3(lambda: [puzzle.check_binding(*it[:5]) for it in items])
    bv_s, _ = med3(lambda: kzg.batch_verify(srs_ref, openings))
    pair_s, _ = med3(lambda: pairing.pairing_check(pairs))
    log(f"verify_batch({VERIFY_BATCH}): median {vb_s:.3f} s of {[round(t, 3) for t in vb_all]} "
        f"on {smi}; apart: {VERIFY_BATCH} check_binding {bind_s:.3f} s, batch_verify "
        f"{bv_s:.3f} s, of which the host pairing_check {pair_s:.3f} s")
    report.update(verify_batch4_s=vb_all, check_binding4_s=bind_s, batch_verify4_s=bv_s,
                  pairing_check_s=pair_s)

    # -- 8. the SRS artifact: save, load through the consistency check ---------------
    art_dir = os.path.join(HERE, "build", "srs")
    os.makedirs(art_dir, exist_ok=True)
    art = os.path.join(art_dir, "dev12.srs")
    digest = srs_artifact.save_srs(art, srs_ref)
    t0 = time.perf_counter()
    loaded = run_path("PuzzleSRS.from_artifact(2^12)",
                      lambda: PuzzleSRS.from_artifact(art, digest, log_degree=12),
                      ["bucket_scan_serial", "seg_prefix", "g1_horner", "g1_bucket_fixup"],
                      absent=["g1_add", "jadd_bucket_total"])
    art_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(
        (loaded.points.x, loaded.points.y, loaded.points.z),
        (puzzle.srs.points.x, puzzle.srs.points.y, puzzle.srs.points.z)))
    if not same or loaded.srs_ref.tau_h != srs_ref.tau_h or loaded.is_dev:
        raise AssertionError("from_artifact did not give the dev SRS's points and tau H")
    evil = ref_kzg.SRS(powers_g1=list(srs_ref.powers_g1), h=srs_ref.h, tau_h=srs_ref.tau_h)
    evil.powers_g1[5] = ref_g1.scalar_mul(prng.randrange(1, r), ref_g1.GENERATOR)
    evil_path = os.path.join(art_dir, "evil12.srs")
    srs_artifact.save_srs(evil_path, evil)
    try:
        PuzzleSRS.from_artifact(evil_path, log_degree=12)
    except srs_artifact.SRSArtifactError as exc:
        if "consistency" not in str(exc):
            raise
    else:
        raise AssertionError("from_artifact accepted an artifact with power 5 changed")
    for path in (art, evil_path):
        os.remove(path)
    log(f"PuzzleSRS.from_artifact(2^12) == the dev SRS (points, tau H), in {art_s:.3f} s; "
        "an artifact with one power changed fails the consistency check")
    report.update(from_artifact_s=art_s)

    # -- 9. the NTT over Fr (B1's fr_ntt_pass) and the pipeline -------------------------
    P = FR.p
    edge_limbs = torch.from_numpy(FR.encode_fast([0, 1, P - 1, P - 2], mont=True)).to(dev)
    inv2 = torch.from_numpy(FR.encode_fast([pow(2, -1, P)], mont=True)).to(dev)

    def fr_rows(rows, n, seed):
        """(16, rows, n) uniform Montgomery limbs on the card."""
        arr = FR.random(rows * n, np.random.default_rng(seed)).reshape(FR.nlimbs, rows, n)
        return torch.from_numpy(arr).to(dev)

    def unstage(a, inv_twiddles, s):
        """The plain inverse of stage s: (A, B) -> ((A + B) / 2, (A - B) / 2w),
        with ``inv_twiddles`` the stage's w^-1."""
        L, B, n = a.shape
        m = 1 << s
        v = a.reshape(L, B, n // (2 * m), 2, m)
        half = inv2.view(L, 1, 1, 1)
        u = fa.mont_mul_plain(FR, fa.add(FR, v[:, :, :, 0], v[:, :, :, 1]), half)
        w = fa.mont_mul_plain(FR, fa.sub(FR, v[:, :, :, 0], v[:, :, :, 1]), half)
        w = fa.mont_mul_plain(FR, w, inv_twiddles.reshape(L, 1, 1, m))
        return torch.stack([u, w], dim=3).reshape(L, B, n)

    def plant_pass(x, s0, k, s, inverse):
        """A pass input made from x whose first 16 butterflies of stage s, in
        row 0, see every pair of the edge values (0, 1, p - 1, p - 2) as (u,
        v): the edges are written at stage s's input, the stages s - 1 .. s0
        undone in plain PyTorch (and, for the first pass, the gather and its
        n^-1), and the plain pass's first s - s0 stages must bring them back."""
        n = x.shape[-1]
        y = x.clone()
        m = 1 << s
        pos = []
        for e in range(16):
            i0 = (e // m) * 2 * m + e % m
            y[:, 0, i0] = edge_limbs[:, e // 4]
            y[:, 0, i0 + m] = edge_limbs[:, e % 4]
            pos += [i0, i0 + m]
        want = y[:, 0, pos].clone()
        inv_table = ntt._stage_table(n, not inverse, dev)
        for t in range(s - 1, s0 - 1, -1):
            y = unstage(y, ntt._stage_twiddles(inv_table, t), t)
        scale = ntt._n_inv_const(n, dev) if inverse and s0 == 0 else None
        if s0 == 0:
            n_mont = torch.from_numpy(FR.encode_fast([n], mont=True)).to(dev)
            y = ntt.bitrev_plain(y, n_mont if inverse else None)
        at_s = ntt.pass_plain(y, ntt._stage_table(n, inverse, dev), s0, s - s0, scale)
        if not torch.equal(at_s[:, 0, pos], want):
            raise AssertionError(f"planting at stage {s} of pass ({s0}, {k}) failed")
        return y

    ntt_inputs = {}
    for rows, log_n in ((1, 22), (1, 20), (1, 16), (1, 12), (NTT_BATCH[0], NTT_BATCH[1])):
        ntt_inputs[(rows, log_n)] = fr_rows(rows, 1 << log_n, 100 + log_n + rows)
    elem = FR.nlimbs * 4  # bytes an element

    def pass_work(rows, n, s0, k, inverse):
        """(bytes, 32-bit multiplies) of a pass: each element read and
        written once, the pass's twiddles read once (and n^-1), rows n / 2
        butterflies a stage (and rows n scalings)."""
        first = s0 == 0
        tw = (1 << k) - 1 if first else (1 << (s0 + k)) - (1 << s0)
        scaled = first and inverse
        nbytes = 2 * elem * rows * n + elem * (tw + scaled)
        return nbytes, FR_MUL_OPS * rows * n * (k / 2 + scaled)

    # every pass of every plan, both directions; at the first, middle and last
    # stage of each the edge butterflies (the first of the three also timed)
    pass_cases = []
    x22 = ntt_inputs[(1, 22)]
    for (rows, log_n), x in ntt_inputs.items():
        n = 1 << log_n
        for inverse in (False, True):
            table = ntt._stage_table(n, inverse, dev)
            for s0, k in ntt._pass_plan(log_n):
                scale = ntt._n_inv_const(n, dev) if inverse and s0 == 0 else None
                out = torch.empty_like(x)
                for s in sorted({s0, s0 + k // 2, s0 + k - 1}):
                    y = plant_pass(x, s0, k, s, inverse)
                    if s0 == 0:
                        kfn = (lambda y=y, out=out, table=table, k=k, scale=scale:
                               ntt.pass_kernel(y, out, table, 0, k, scale))
                        tfn = kfn
                    else:
                        def kfn(y=y, table=table, s0=s0, k=k):
                            z = y.clone()
                            return ntt.pass_kernel(z, z, table, s0, k)
                        work = y.clone()
                        tfn = (lambda work=work, table=table, s0=s0, k=k:
                               ntt.pass_kernel(work, work, table, s0, k))
                    nbytes, nops = pass_work(rows, n, s0, k, inverse) if s == s0 else (None, None)
                    pass_cases.append((
                        f"(16, {rows}, 2^{log_n}) pass ({s0}, {k})"
                        + (" inverse" if inverse else "") + f", edges at stage {s}", kfn,
                        lambda y=y, table=table, s0=s0, k=k, scale=scale:
                            ntt.pass_plain(y, table, s0, k, scale),
                        nbytes, nops, tfn))
    # the first pass at 2^22 beside one PyTorch call that moves the same
    # permutation (its stages have no such call)
    perm22 = torch.from_numpy(ntt._bitrev_perm(x22.shape[-1])).to(dev).long()
    check("fr_ntt_pass", "snarkos_tpu_torch/csrc/ntt.cu", "snarkos_tpu/ops/modarith.py:171",
          pass_cases, ntt.pass_kernel, library=lambda: x22.index_select(-1, perm22))
    del ntt_inputs, pass_cases, x22, perm22

    def only(counts):
        """Exactly these launches and none of any other kernel."""
        return {**{k["name"]: 0 for k in kernels}, **counts}

    def ntt_counts(log_n):
        return only({"fr_ntt_pass": len(ntt._pass_plan(log_n))})

    # ntt at 2^22: the round trip, the plain stage loop, and the host's
    # poly_eval at k = 0 and 4 random k (on the raw limbs, a R-multiple of
    # the values: the transform is linear)
    n22 = 1 << NTT_LOGS[-1]
    a22 = fr_rows(1, n22, 22).reshape(FR.nlimbs, n22)
    ntt.ntt(a22)  # the twiddle tables of the size
    ntt.intt(a22)
    ev22 = run_path(f"ntt(2^{NTT_LOGS[-1]})", lambda: ntt.ntt(a22),
                    ["fr_ntt_pass"], exact=ntt_counts(NTT_LOGS[-1]))
    back22 = run_path(f"intt(2^{NTT_LOGS[-1]})", lambda: ntt.intt(ev22),
                      ["fr_ntt_pass"], exact=ntt_counts(NTT_LOGS[-1]))
    if not torch.equal(back22, a22):
        raise AssertionError("intt(ntt(a)) != a at 2^22")
    if not torch.equal(ev22, ntt.ntt_plain(a22)):
        raise AssertionError("ntt(a) != ntt_plain(a) at 2^22")
    coeffs_raw = FR.decode_fast(a22.cpu().numpy())
    ev_raw = ev22.cpu().numpy()
    omega22 = ref_ntt.root_of_unity(n22)
    for k in [0] + [prng.randrange(1, n22) for _ in range(4)]:
        want = ref_ntt.poly_eval(coeffs_raw, pow(omega22, k, P))
        if FR.decode_fast(ev_raw[:, k:k + 1])[0] != want:
            raise AssertionError(f"ntt(a)[{k}] != poly_eval(a, omega^{k}) at 2^22")
    del coeffs_raw, ev_raw, back22
    log("ntt at 2^22: intt(ntt(a)) == a, ntt(a) == ntt_plain(a), and ntt(a)[k] == "
        "poly_eval(a, omega^k) on the host for k = 0 and 4 random k")
    for log_n in (12, 16):
        a = fr_rows(1, 1 << log_n, log_n).reshape(FR.nlimbs, -1)
        for inverse in (False, True):
            got = FR.decode_fast(ntt.ntt(a, inverse).cpu().numpy(), mont=True)
            if got != ref_ntt.ntt(FR.decode_fast(a.cpu().numpy(), mont=True), inverse):
                raise AssertionError(f"ntt(invert={inverse}) at 2^{log_n} != the host ntt")
    log("ntt and intt at 2^12 and 2^16 equal the host crypto/ref/ntt.py")
    rows_b, log_b = NTT_BATCH
    xb = fr_rows(rows_b, 1 << log_b, 7)
    ntt.ntt_batched(xb)
    evb = run_path(f"ntt_batched({rows_b} x 2^{log_b})", lambda: ntt.ntt_batched(xb),
                   ["fr_ntt_pass"], exact=ntt_counts(log_b))
    for r_ in range(rows_b):
        if not torch.equal(evb[:, r_], ntt.ntt(xb[:, r_].contiguous())):
            raise AssertionError(f"ntt_batched row {r_} != ntt of the row")
    log(f"each row of ntt_batched over (16, {rows_b}, 2^{log_b}) == ntt of the row")

    def host_ms3(fn):
        """med3 in ms."""
        med, ts = med3(fn)
        return med * 1e3, [t * 1e3 for t in ts]

    ntt_times = {}
    for log_n in NTT_LOGS:
        a = fr_rows(1, 1 << log_n, 200 + log_n).reshape(FR.nlimbs, -1)
        calls = [("ntt", lambda a=a: ntt.ntt(a))]
        if log_n == NTT_LOGS[-1]:
            calls.append(("intt", lambda a=a: ntt.intt(a)))
        for what, fn in calls:
            fn()
            med, ts = host_ms3(fn)
            dev_ms = graph_ms(fn, 3, 1)
            ntt_times[f"{what}_2^{log_n}"] = {"ms": ts, "median_ms": med, "device_ms": dev_ms,
                                              "elems_per_s": (1 << log_n) / med * 1e3}
            log(f"{what}(2^{log_n}): median {med:.4f} ms of {[round(t, 4) for t in ts]} "
                f"(device {dev_ms:.4f} ms) -> {(1 << log_n) / med * 1e3:.0f} elems/s on {smi}")

    def plan_run(x, out, table, log_n, k_max=None, log_elems=None, threads=None):
        """A forward transform of x into out by the plan for k_max, with the
        tile of log_elems and the block size given (the defaults else)."""
        for s0, k in ntt._pass_plan(log_n, k_max):
            ntt.pass_kernel(x if s0 == 0 else out, out, table, s0, k,
                            cols=ntt._pass_cols(log_n, s0, k, log_elems), threads=threads)
        return out

    # the device time of each pass at 2^22 (a CUDA graph of 20 launches,
    # median of 3 replays; the later passes in place)
    a = fr_rows(1, n22, 23)
    out = torch.empty_like(a)
    table = ntt._stage_table(n22, False, dev)
    per_pass = [graph_ms(lambda s0=s0, k=k: ntt.pass_kernel(a if s0 == 0 else out, out, table,
                                                            s0, k), 3, 20)
                for s0, k in ntt._pass_plan(NTT_LOGS[-1])]
    ntt_times["pass_device_ms_2^22"] = per_pass
    log(f"fr_ntt_pass at 2^22, device ms by pass {ntt._pass_plan(NTT_LOGS[-1])}: "
        f"{[round(t, 4) for t in per_pass]}; sum {sum(per_pass):.3f} ms")
    # the sweep: plans (k_max), tiles (2^log_elems elements) and block sizes
    # at 2^22 and 2^20, each transform checked against the default's output,
    # device ms a transform (a graph of 3, median of 3 replays)
    sweep = []
    for log_n in (NTT_LOGS[-1], NTT_LOGS[-2]):
        n = 1 << log_n
        x = fr_rows(1, n, 300 + log_n)
        table = ntt._stage_table(n, False, dev)
        want = ntt.ntt_batched(x)
        for k_max in NTT_SWEEP_K_MAX:
            plan = ntt._pass_plan(log_n, k_max)
            for log_elems in NTT_SWEEP_LOG_ELEMS:
                cols = [ntt._pass_cols(log_n, s0, k, log_elems) for s0, k in plan]
                if max(ntt._pass_smem(k, c, s0 == 0) for (s0, k), c in zip(plan, cols)) \
                        > ntt.PASS_SMEM_MAX:
                    continue
                for threads in NTT_SWEEP_THREADS:
                    out = torch.empty_like(x)

                    def fn(x=x, out=out, table=table, log_n=log_n, k_max=k_max,
                           log_elems=log_elems, threads=threads):
                        return plan_run(x, out, table, log_n, k_max, log_elems, threads)

                    if not torch.equal(fn(), want):
                        raise AssertionError(f"sweep 2^{log_n} k_max={k_max} "
                                             f"log_elems={log_elems} threads={threads}: wrong")
                    ms = graph_ms(fn, 3, 3)
                    sweep.append({"log_n": log_n, "plan": plan, "cols": cols,
                                  "threads": threads, "device_ms": ms})
                    log(f"sweep 2^{log_n}: plan {plan} cols {cols} threads {threads}: "
                        f"device {ms:.4f} ms")
        best = min((r for r in sweep if r["log_n"] == log_n), key=lambda r: r["device_ms"])
        plan = ntt._pass_plan(log_n)
        log(f"sweep 2^{log_n}: fastest plan {best['plan']} cols {best['cols']} threads "
            f"{best['threads']} ({best['device_ms']:.4f} ms); the default plan {plan} cols "
            f"{[ntt._pass_cols(log_n, s0, k) for s0, k in plan]} threads {ntt.PASS_THREADS}")
    ntt_times["sweep"] = sweep
    del a, out, table, x, want
    report["ntt"] = ntt_times

    # the pipeline of entry.entry(): at JAX's 2^10 byte for byte against the
    # host composition, then at 2^22 with its launches
    fwd, (seed10, ctr10) = entry_mod.entry(log_n=10)
    out10 = fwd(seed10, ctr10)
    coeffs10 = [ref_poseidon.hash_many([sv, cv], 2, domain=entry_mod.DOMAIN)[0]
                for sv, cv in zip(FR.decode_fast(seed10.cpu().numpy(), mont=True),
                                  FR.decode_fast(ctr10.cpu().numpy(), mont=True))]
    want10 = FR.encode_fast([v * v % P for v in ref_ntt.ntt(coeffs10)], mont=True)
    if not np.array_equal(out10.cpu().numpy(), want10):
        raise AssertionError("entry.forward at 2^10 != the host Poseidon -> ntt -> square")
    log("entry.forward at 2^10 == host Poseidon ('graft.entry') -> host ntt -> square, "
        "limb for limb")
    fwd, (seed22, ctr22) = entry_mod.entry(log_n=PIPE_LOG)
    fwd(seed22, ctr22)
    out22 = run_path(f"entry.forward(2^{PIPE_LOG})", lambda: fwd(seed22, ctr22),
                     ["fr_poseidon_permute", "fr_ntt_pass", "mont_mul"],
                     exact=only({"fr_poseidon_permute": 1, "mont_mul": 1,
                                 "fr_ntt_pass": len(ntt._pass_plan(PIPE_LOG))}))
    coeffs22 = poseidon.hash_fixed(torch.stack([seed22, ctr22]), 2, domain=entry_mod.DOMAIN)[0]
    lanes = [0, 1, (1 << PIPE_LOG) - 1] + [prng.randrange(1 << PIPE_LOG) for _ in range(5)]
    for lane in lanes:
        sv, cv = (FR.decode_fast(t[:, lane:lane + 1].cpu().numpy(), mont=True)[0]
                  for t in (seed22, ctr22))
        got = FR.decode_fast(coeffs22[:, lane:lane + 1].cpu().numpy(), mont=True)[0]
        if got != ref_poseidon.hash_many([sv, cv], 2, domain=entry_mod.DOMAIN)[0]:
            raise AssertionError(f"pipeline coefficient {lane} != the host Poseidon")
    evals22 = ntt.ntt_plain(coeffs22)
    for lo in range(0, 1 << PIPE_LOG, 1 << 20):  # the plain square in slices: its memory
        part = evals22[:, lo:lo + (1 << 20)]
        if not torch.equal(out22[:, lo:lo + (1 << 20)], fa.mont_mul_plain(FR, part, part)):
            raise AssertionError(f"entry.forward(2^{PIPE_LOG}) != square(ntt_plain(coeffs))")
    del evals22
    pipe_med, pipe_ts = host_ms3(lambda: fwd(seed22, ctr22))
    # its three steps apart, and the sponge's one permutation within the
    # first (medians of 3 host-clock calls)
    ev_c = ntt.ntt(coeffs22)
    state22 = torch.stack([coeffs22] * 3)
    steps = {"hash_fixed": host_ms3(lambda: poseidon.hash_fixed(
                 torch.stack([seed22, ctr22]), 2, domain=entry_mod.DOMAIN))[0],
             "of which permute": host_ms3(lambda: poseidon.permute(state22, 2))[0],
             "ntt": host_ms3(lambda: ntt.ntt(coeffs22))[0],
             "square": host_ms3(lambda: fa.mont_mul(FR, ev_c, ev_c))[0]}
    del coeffs22, ev_c, state22
    log(f"entry.forward(2^{PIPE_LOG}): coefficients == host Poseidon at {len(lanes)} lanes, "
        f"output == square(ntt_plain(coefficients)); median {pipe_med:.3f} ms of "
        f"{[round(t, 3) for t in pipe_ts]} on {smi}; apart: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in steps.items()))
    report["pipeline"] = {"log_n": PIPE_LOG, "ms": pipe_ts, "median_ms": pipe_med,
                          "steps_median_ms": steps}

    # -- 10. output -----------------------------------------------------------------
    launched = {k["name"]: any(k["launches_per_path"].values()) for k in kernels}
    unused = [k for k, v in launched.items() if not v and k not in NO_PATH_YET]
    if unused:
        raise AssertionError(f"kernels launched on no path: {unused}")
    found = [k for k in NO_PATH_YET if launched[k]]
    if found:
        raise AssertionError(f"kernels of NO_PATH_YET launched on a path: {found}")
    for k, caller in NO_PATH_YET.items():
        log(f"{k}: launched on no path yet (next caller: {caller})")
    for kern in kernels:
        del kern["counter"]
        kern["launches"] = sum(kern["launches_per_path"].values())
    line = {"kernels": [{k: v for k, v in kern.items() if k != "shapes"} for kern in kernels]}
    report["kernels"] = kernels
    report["wall_s"] = time.perf_counter() - T_START
    log(f"chip_smoke: {report['wall_s']:.1f} s in all")
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
