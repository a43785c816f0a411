"""Times of kernel B1's two Fr passes (the Poseidon sponge, the epoch
program) and of the paths that run them, in one checkout.

    python3 scripts/time_fr_passes.py [--root DIR] [--reps 5] [--check]

Builds the checkout at DIR (this one by default) and prints one JSON line
with the card's name and power limit and, each after a warm-up call:

- ``poseidon.permute_kernel`` at (3, 16, 32768), (3, 16, 65536), (3, 16,
  2^22) and (5, 16, 4096): device ms a launch (3 launches captured in one
  CUDA graph, median of ``--reps`` replays) and ms (CUDA events around one
  call, median);
- ``poseidon.hash_fixed`` at (2, 16, 2^22), rate 2, the pipeline's domain,
  and ``entry.forward(2^22)``: ms a call (CUDA events around a call ending
  in a device sync, median of ``--reps``);
- ``EpochProgram.apply`` of the test fixture's epoch at (16, 8, 4096),
  (16, 16, 4096), (16, 8, 2^16) and (16, 2, 2^20) (the last two: log
  degree 16 and 20, the global variant): device ms (one call captured in a
  CUDA graph, median of replays) and ms (events around one call);
- ``Puzzle.prove_batch`` over 8 and 16 nonces at 2^12: solutions/s (median
  of ``--reps`` synced host-clock calls);
- the launch count of every counted wrapper during one call of each path,
  and a sha256 of each output, so that two checkouts can be seen to agree.

``--check`` first holds the permutation at 32768 and 4096 lanes and the
epoch program at (16, 8, 4096) to their plain versions on the card (a
mismatch exits 1), and prints the build log's register and spill lines of
the source that holds them. Inputs come from fixed numpy seeds. To compare
two checkouts, run it on both in turns on one card (old, new, new, old).
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fr_passes: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np

    from snarkos_tpu_torch import entry as entry_mod
    from snarkos_tpu_torch.ops import _build, poseidon
    from snarkos_tpu_torch.ops import modarith as fa
    from snarkos_tpu_torch.ops import puzzle as puzzle_mod
    from snarkos_tpu_torch.ops.fieldspec import FR

    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    counters = {f"{mod.__name__.rsplit('.', 1)[-1]}.{name}": f
                for mod in (fa, poseidon, puzzle_mod) for name, f in vars(mod).items()
                if callable(f) and hasattr(f, "launches")}
    with open(os.path.join(root, "tests", "fixtures", "torch_puzzle_k12_b8.json")) as fh:
        fixture = json.load(fh)
    rng = np.random.default_rng(1515)

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    def launches(fn):
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counters.items() if f.launches}

    def event_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def graph_ms(fn, inner):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / inner)
        del graph
        return statistics.median(times)

    def fr_state(t, lanes):
        x = np.ascontiguousarray(FR.random(t * lanes, rng).reshape(FR.nlimbs, t, lanes)
                                 .transpose(1, 0, 2))
        x[:, :, :3] = FR.encode_fast([0, 1, FR.p - 1], mont=True)[None]
        return torch.from_numpy(x).to(dev)

    out = {"card": smi, "root": root, "build_s": build_s, "torch": torch.__version__}
    if args.check:
        for name in _build.SOURCES:
            log = _build.build_log(name)
            if "fr_poseidon_permute" in open(os.path.join(_build.CSRC, f"{name}.cu")).read():
                out["ptxas"] = [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln or "Compiling" in ln]
        for rate, lanes in ((2, 32768), (4, 4096)):
            st = fr_state(rate + 1, lanes)
            if not torch.equal(poseidon.permute_kernel(st, rate), poseidon.permute_plain(st, rate)):
                print(f"time_fr_passes: permute rate {rate} at {lanes} lanes != plain",
                      file=sys.stderr)
                return 1
        prog = puzzle_mod.EpochProgram(bytes.fromhex(fixture["epoch_hash"]), 4096, dev)
        v = torch.from_numpy(FR.random(8 * 4096, rng).reshape(FR.nlimbs, 8, 4096)).to(dev)
        want = prog.apply_plain(v)
        if not torch.equal(prog.apply(v), want):
            print("time_fr_passes: the epoch program at (16, 8, 4096) != plain", file=sys.stderr)
            return 1
        out["checked"] = True
        del prog, v, want

    perm = {}
    for rate, lanes in ((2, 32768), (2, 65536), (2, 1 << 22), (4, 4096)):
        st = fr_state(rate + 1, lanes)
        got, counts = launches(lambda: poseidon.permute_kernel(st, rate))
        perm[f"({rate + 1}, 16, {lanes})"] = {
            "device_ms": graph_ms(lambda: poseidon.permute_kernel(st, rate), 3),
            "ms": event_ms(lambda: poseidon.permute_kernel(st, rate)),
            "launches": counts, "sha": digest(got)}
    out["permute"] = perm
    del st, got

    fwd, (seed, ctr) = entry_mod.entry(log_n=22)
    inputs = torch.stack([seed, ctr])
    got, counts = launches(lambda: poseidon.hash_fixed(inputs, 2, domain=entry_mod.DOMAIN))
    out["hash_fixed(2^22)"] = {
        "ms": event_ms(lambda: poseidon.hash_fixed(inputs, 2, domain=entry_mod.DOMAIN)),
        "launches": counts, "sha": digest(got)}
    got, counts = launches(lambda: fwd(seed, ctr))
    out["entry.forward(2^22)"] = {"ms": event_ms(lambda: fwd(seed, ctr)), "launches": counts,
                                  "sha": digest(got)}
    del inputs, got, seed, ctr

    epoch = bytes.fromhex(fixture["epoch_hash"])
    progs = {}
    for batch, k in ((8, 4096), (16, 4096), (8, 1 << 16), (2, 1 << 20)):
        prog = puzzle_mod.EpochProgram(epoch, k, dev)
        v = torch.from_numpy(FR.random(batch * k, rng).reshape(FR.nlimbs, batch, k)).to(dev)
        got, counts = launches(lambda: prog.apply(v))
        progs[f"(16, {batch}, {k})"] = {"device_ms": graph_ms(lambda: prog.apply(v), 1),
                                        "ms": event_ms(lambda: prog.apply(v)),
                                        "launches": counts, "sha": digest(got)}
        del prog, v, got
    out["epoch_program"] = progs

    puzzle = puzzle_mod.Puzzle(log_degree=fixture["log_degree"])
    nonces = [row["nonce"] for row in fixture["solutions"]]
    for batch in (8, 16):
        batch_nonces = (nonces + [n + 1000 for n in nonces])[:batch]
        puzzle.prove_batch(epoch, fixture["address"], batch_nonces)
        secs = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sols = puzzle.prove_batch(epoch, fixture["address"], batch_nonces)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        _, counts = launches(lambda: puzzle.prove_batch(epoch, fixture["address"], batch_nonces))
        out[f"prove_batch({batch})"] = {
            "s": secs, "solutions_per_s": batch / statistics.median(secs), "launches": counts,
            "sha": hashlib.sha256(b"".join(s.commitment + s.witness for s in sols))
            .hexdigest()[:16]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
