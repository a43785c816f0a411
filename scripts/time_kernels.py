"""Device times of the kernels that carry the port's Montgomery multiply
(``csrc/field.cuh``), at the paths' shapes, in one checkout.

    python3 scripts/time_kernels.py [--root DIR] [--reps 7]

Builds ``mont_mul``, ``bucket_scan`` and ``bucket_scan_fast`` of the
checkout at DIR (this one by default; a source that does not build, or a
library without the permutation's entry, is reported and its rows left
out) and times each kernel on the card alone:
CUDA events around 20 back-to-back launches (3 for the scans and the
permutation) queued behind a spin kernel, so that the device never waits
for the host between them; median of ``--reps`` runs:
  - B1 ``mont_mul`` at Fq (24, 2^20) and Fr (16, 32768);
  - B1's ``fr_poseidon_permute`` at (3, 16, 32768), the leaves of
    prove_batch(8);
  - B5 ``bucket_scan`` on a window of a batch-16 multi-MSM, (24, 256, 256),
    and of a 2^20 MSM, (24, 2048, 512), at its team size;
  - B6 ``bucket_scan_fast`` on the 2^20 window at its team size.
The windows are those of the paths (random scalars, c = 6 and c = 14, the
chain layout of ``msm.chain_layout``) over multiples of a random point.
Prints one JSON line with the card's name and power limit. To compare two
versions of the multiply, run it on two checkouts in turns on one card
(old, new, new, old).
"""

import argparse
import json
import os
import random
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# a spin of about 25 ms at the H100's 1.98 GHz: longer than the host takes to
# queue a run of launches
SPIN_CYCLES = 50_000_000


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np

    from snarkos_tpu_torch.crypto import params
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1
    from snarkos_tpu_torch.ops import _build, g1, msm, msm_kernels, poseidon
    from snarkos_tpu_torch.ops import modarith as fa
    from snarkos_tpu_torch.ops.fieldspec import FQ, FR

    built = []
    for name in ("mont_mul", "bucket_scan", "bucket_scan_fast"):
        try:
            _build.build((name,))
            built.append(name)
        except RuntimeError as err:  # reported, and the source's rows left out
            print(f"time_kernels: {name}.cu does not build in {args.root}:\n{err}",
                  file=sys.stderr)
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    prng = random.Random(5)

    def ms(fn, inner):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    out = {}
    if "mont_mul" not in built:
        return 1
    for spec, n in ((FQ, 1 << 20), (FR, 32768)):
        a, b = (torch.from_numpy(spec.random(n, rng)).to(dev) for _ in range(2))
        out[f"mont_mul {spec.name} ({spec.nlimbs}, {n})"] = ms(
            lambda: fa.mont_mul_kernel(spec, a, b), 20)
    lanes = 8 * 4096
    state = torch.from_numpy(np.ascontiguousarray(
        FR.random(3 * lanes, rng).reshape(FR.nlimbs, 3, lanes).transpose(1, 0, 2))).to(dev)
    if hasattr(_build.load("mont_mul"), "fr_poseidon_permute"):
        out[f"fr_poseidon_permute (3, 16, {lanes})"] = ms(
            lambda: poseidon.permute_kernel(state, 2), 3)

    h = ref_g1.scalar_mul(prng.randrange(1, params.FR_MODULUS), ref_g1.GENERATOR)
    pts, acc = [], h
    for _ in range(4096):
        pts.append(ref_g1.from_affine(ref_g1.affine(acc)))
        acc = ref_g1.add(acc, h)
    base = g1.encode_points(pts, dev)

    def window(n, batch):
        """The middle window of an n-point MSM (a batch-``batch`` multi-MSM)
        over the tiled base: (xs, ys, flags) in the wide chain layout."""
        c = msm.fused_window_bits(n // batch)
        x = base.x.repeat(1, n // 4096)
        y = base.y.repeat(1, n // 4096)
        packed = msm.signed_window_digits(torch.from_numpy(FR.random(n, rng)).to(dev), c)
        src = msm.chain_src(n, msm._default_lanes(n), msm_kernels.CHUNK, False, dev)
        off = None
        if batch > 1:
            off = (torch.arange(n, device=dev) // (n // batch)) * ((1 << (c - 1)) + 1)
        keys, xs, ys, heads = msm.chain_layout(x, torch.cat([y, fa.neg(FQ, y)], dim=-1),
                                               packed[packed.shape[0] // 2], src, off)
        nonzero = (keys > 0).to(torch.int32)[src.reshape(-1)].reshape(heads.shape)
        return xs, ys, heads.unsqueeze(0).contiguous(), nonzero.unsqueeze(0).contiguous()

    chunk = msm_kernels.CHUNK
    for n, batch in ((1 << 16, 16), (1 << 20, 1)):
        xs, ys, fl, nz = window(n, batch)
        shape = tuple(xs.shape)
        if "bucket_scan" in built:
            out[f"bucket_scan {shape} T={msm_kernels.SCAN_TEAM}"] = ms(
                lambda: msm_kernels.bucket_scan_kernel(xs, ys, fl, chunk), 3)
        if batch == 1 and "bucket_scan_fast" in built:
            out[f"bucket_scan_fast {shape} T={msm_kernels.FAST_TEAM}"] = ms(
                lambda: msm_kernels.bucket_scan_fast_kernel(xs, ys, fl, nz, chunk), 3)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "card": card, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
