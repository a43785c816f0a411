"""Where the time of one prove_batch, or of one large MSM, goes on the card
(PyTorch port).

    python3 scripts/profile_torch_prover.py [--batch 8] [--log-degree 12]
    python3 scripts/profile_torch_prover.py --msm-log-n 20
    python3 scripts/profile_torch_prover.py --batch 8 --reps 5 --root DIR

Builds the port's Puzzle on the card and warms up with one prove_batch, then
traces one more under torch.profiler (CPU and CUDA activity); with
``--msm-log-n n`` it does the same with msm.msm_affine over the first 2^n
dev SRS powers and random scalars instead. Prints the wall time of the
traced call, the device busy time (union of kernel intervals), the idle
share, the number of device activities and of host syncs (the CUDA
runtime's synchronize calls), and device time by kernel name. The full table goes to
chiprun_out/profile_torch_prover.txt (profile_torch_msm.txt for an MSM).

``--reps N`` first times N untraced calls after the warm-up, each ended by a
device sync (host clock), and prints one JSON line with the times, their
median and the rate (solutions/s or points/s), the card's name and power
limit. ``--root DIR`` imports the port from the checkout at DIR instead of
this one: point it at two checkouts in turns (parent, change, change,
parent) on one card to compare them. Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--log-degree", type=int, default=12)
    ap.add_argument("--msm-log-n", type=int, default=0)
    ap.add_argument("--reps", type=int, default=0)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_prover: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np

    from snarkos_tpu_torch.ops import _build, msm
    from snarkos_tpu_torch.ops.fieldspec import FR
    from snarkos_tpu_torch.ops.puzzle import Puzzle, PuzzleSRS

    _build.build()
    if args.msm_log_n:
        n = 1 << args.msm_log_n
        srs = PuzzleSRS.dev(args.msm_log_n)
        x, y = srs.points.x[:, :n].contiguous(), srs.points.y[:, :n].contiguous()
        scalars = torch.from_numpy(FR.random(n, np.random.default_rng(20))).to(x.device)
        what, out_name = f"msm_affine(2^{args.msm_log_n})", "profile_torch_msm.txt"
        work = n

        def call():
            msm.msm_affine(x, y, scalars)
    else:
        puzzle = Puzzle(log_degree=args.log_degree)
        epoch, address, nonces = b"\x01" * 32, "aleo1benchprover", list(range(args.batch))
        what = f"prove_batch({args.batch}) at 2^{args.log_degree}"
        out_name = "profile_torch_prover.txt"
        work = args.batch

        def call():
            puzzle.prove_batch(epoch, address, nonces)
    call()
    torch.cuda.synchronize()
    if args.reps:
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        med = statistics.median(times)
        print(json.dumps({"root": args.root, "path": what, "card": card, "s": times,
                          "median_s": med, "per_s": work / med}), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:  # union of device intervals, in microseconds
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", out_name), "w") as fh:
        fh.write(table)
    # host syncs: the runtime's stream and device synchronisations (a read of
    # a CUDA tensor's value, a copy to the host, the call's final sync)
    syncs = sum(ev.count for ev in prof.key_averages() if "Synchronize" in ev.key)
    print(f"{what}: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms, idle share {1 - busy / 1e6 / wall:.3f}, "
          f"{len(spans)} device activities, {syncs} host syncs on "
          f"{torch.cuda.get_device_name(0)}")
    rows = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0) or 0
        if t > 0:
            rows[ev.key] = (t, ev.count)
    for key, (t, count) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
