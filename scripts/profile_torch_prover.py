"""Where the time of one prove_batch goes on the card (PyTorch port).

    python3 scripts/profile_torch_prover.py [--batch 8] [--log-degree 12]

Builds the port's Puzzle on the card, warms up with one prove_batch, then
traces one more under torch.profiler (CPU and CUDA activity) and prints:
the wall time of the traced call, the device busy time (union of kernel
intervals), the idle share, and device time by kernel name. The full table
goes to chiprun_out/profile_torch_prover.txt. Needs a CUDA device.
"""

import argparse
import os
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_prover: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from snarkos_tpu_torch.ops import _build
    from snarkos_tpu_torch.ops.puzzle import Puzzle

    _build.build()
    puzzle = Puzzle(log_degree=args.log_degree)
    epoch, address, nonces = b"\x01" * 32, "aleo1benchprover", list(range(args.batch))
    puzzle.prove_batch(epoch, address, nonces)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        puzzle.prove_batch(epoch, address, nonces)
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
    with open(os.path.join(ROOT, "chiprun_out", "profile_torch_prover.txt"), "w") as fh:
        fh.write(table)
    print(f"prove_batch({args.batch}) at 2^{args.log_degree}: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms, idle share {1 - busy / 1e6 / wall:.3f}, "
          f"{len(spans)} device activities on {torch.cuda.get_device_name(0)}")
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
