"""Host-clock times of the generic MSM engine's calls in one checkout.

    python3 scripts/time_generic.py [--root DIR] [--reps 3]

Builds the checkout at DIR (this one by default) and prints one JSON line
with the card's name and power limit and, each after a warm-up call and
ending in a device sync: ``msm.msm`` over 2^16 Jacobian bases (the first
2^16 dev SRS powers, each rescaled on the card by a random lambda, every
64th the identity; ``--reps`` calls), ``msm_dist`` at world 1 over NCCL
over the 2^20 dev SRS powers (``--reps`` calls) and over those powers tiled
16 times (2^24, one call, with its peak device memory); each call's kernel
launches and its result as affine hex, so that two checkouts can be seen to
agree. Scalars are drawn on the card from fixed seeds. To compare two
checkouts, run it on both in turns on one card (old, new, new, old).
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_generic: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch.distributed as dist

    from snarkos_tpu_torch.ops import _build, g1, g1_kernels, msm, msm_kernels
    from snarkos_tpu_torch.ops import modarith as fa
    from snarkos_tpu_torch.ops.fieldspec import FQ, FR
    from snarkos_tpu_torch.ops.puzzle import PuzzleSRS
    from snarkos_tpu_torch.parallel import mesh as pmesh, msm_dist

    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    counters = {name: f for mod in (g1_kernels, msm_kernels) for name, f in vars(mod).items()
                if callable(f) and hasattr(f, "launches")}

    def scalars(n, seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        k = torch.randint(0, 1 << 16, (FR.nlimbs, n), generator=gen, device=dev,
                          dtype=torch.int32)
        k[-1] &= 0x0FFF  # below 2^252 < r: canonical
        return k

    def affine_hex(p):
        """The width-1 result as hex affine limbs, or "identity"."""
        x, y, inf = g1.to_affine(p)
        if bool(inf[0]):
            return "identity"
        return [t[:, 0].cpu().numpy().tobytes().hex() for t in (x, y)]

    def timed(fn, reps):
        """(seconds of each call, launches of the last, its affine hex)"""
        fn()
        torch.cuda.synchronize()
        secs = []
        for _ in range(reps):
            for f in counters.values():
                f.launches = 0
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return (secs, {k: f.launches for k, f in counters.items() if f.launches},
                affine_hex(out))

    srs = PuzzleSRS.dev(20, device=dev)
    n20 = 1 << 20
    bases = g1.JacobianPoints(*(t[:, :n20].contiguous()
                                for t in (srs.points.x, srs.points.y, srs.points.z)))
    out = {"root": root, "card": smi}

    # msm.msm on 2^16 Jacobian bases: (x lam^2, y lam^3, z lam), every 64th z = 0
    n16 = 1 << 16
    lam = torch.from_numpy(FQ.random(n16, np.random.default_rng(16))).to(dev)
    lam2 = fa.mont_mul(FQ, lam, lam)
    p16 = g1.JacobianPoints(fa.mont_mul(FQ, bases.x[:, :n16].contiguous(), lam2),
                            fa.mont_mul(FQ, bases.y[:, :n16].contiguous(),
                                        fa.mont_mul(FQ, lam2, lam)),
                            lam.clone())
    p16.z[:, ::64] = 0
    k16 = scalars(n16, 16)
    secs, launches, point = timed(lambda: msm.msm(p16, k16), args.reps)
    out["msm_generic_2^16"] = {"s": secs, "median_s": statistics.median(secs),
                               "launches": launches, "point": point}

    tmp = tempfile.mkdtemp(prefix="time-generic-")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
                            world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh(1)
        k20 = scalars(n20, 20)
        secs, launches, point = timed(lambda: msm_dist.msm_dist(bases, k20, mesh), args.reps)
        out["msm_dist_2^20"] = {"s": secs, "median_s": statistics.median(secs),
                                "launches": launches, "point": point}
        n24 = 1 << 24
        b24 = g1.JacobianPoints(*(t.repeat(1, n24 // n20) for t in (bases.x, bases.y, bases.z)))
        k24 = scalars(n24, 24)
        del srs, p16
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        res = msm_dist.msm_dist(b24, k24, mesh)
        torch.cuda.synchronize()
        s24 = time.perf_counter() - t0
        out["msm_dist_2^24"] = {"s": s24, "peak_bytes": torch.cuda.max_memory_allocated(dev),
                                "launches": {k: f.launches for k, f in counters.items()
                                             if f.launches},
                                "point": affine_hex(res)}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
