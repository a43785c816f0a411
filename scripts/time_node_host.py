"""Host-clock times of the node's ledger paths in one checkout: the
genesis (``ledger.make_genesis``: the credits.aleo deploy proved, every
commitment on the card) and the block checks of the golden chain's blocks 1
and 2 (``Ledger.check_next_block``), on the ledger fixture's committee.

    python3 scripts/time_node_host.py [--root DIR] [--reps 3]

Builds the checkout at DIR (this one by default) and prints one JSON line
with the card's name and power limit, the host's CPU, and for each path the
host seconds of its first call in the process (what a node pays as it
starts: the genesis's program index and transcripts built anew) and of
``--reps`` calls after it (the genesis anew each call, its cache cleared;
each block check on a fresh ledger) with their median. To compare two
checkouts, run it on both in turns on one card (old, new, new, old): the
host engines of ``utils/native.py`` move these paths, the card's share does
not change.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join("tests", "fixtures", "torch_ledger_dev4.json")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_node_host: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from snarkos_tpu_torch import convert
    from snarkos_tpu_torch.node import ledger
    from snarkos_tpu_torch.ops import _build
    from snarkos_tpu_torch.ops import puzzle

    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    cpu = ", ".join(f"{key} {val.strip()}" for key, _, val in
                    (ln.partition(":") for ln in cpu.splitlines())
                    if key in ("Model name", "CPU family", "Model", "CPU(s)"))
    with open(os.path.join(root, FIXTURE)) as fh:
        fx = json.load(fh)
    dev = torch.device("cuda")
    comm = convert.committee(bytes.fromhex(fx["committee"]))
    blocks = [convert.block(bytes.fromhex(b)) for b in fx["blocks"]]
    puzzle.global_puzzle(fx["log_degree"], dev)
    for need in fx["srs_digest"]:
        ledger.execution_srs(int(need), dev)

    def genesis():
        ledger._GENESIS_CACHE.clear()
        return ledger.make_genesis(comm, dev)

    def check(b):
        led = ledger.Ledger(comm, device=dev)
        for prev in blocks[:b]:
            led.advance_to_next_block(prev)

        def run():
            led.check_next_block(blocks[b])
        return run

    out = {"root": root, "card": smi, "cpu": cpu}
    for label, make in (("make_genesis_s", lambda: genesis),
                        ("check_block1_s", lambda: check(0)),
                        ("check_block2_s", lambda: check(1))):
        fn = make()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        runs = []
        for _ in range(args.reps):
            fn = make()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        out[label] = {"first": first, "median": statistics.median(runs), "runs": runs}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
