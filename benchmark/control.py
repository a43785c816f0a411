"""The readings that a cell's limits are set from, on the card, in one
process: runs of the program as it is (``--sound`` seeds) and runs of the
control (``--control`` seeds), each a short window at the cell's own size
and load, each judged as a benchmark run judges it.

    python3 -m benchmark.control --workload prover-b8 --sound 1,2,3 --control 4,5,6 --seconds 3

The control is the program computing in a lower precision than the
configuration states: the MSM engine's scalars cut to their low 240 bits
(the top 16-bit limb of each set to 0) before ``ops/msm.msm_affine_multi``
and ``msm_affine`` run, as a window plan that drops the top window would
compute. Prints one JSON line a run: the seed, the kind, ``correct`` and the
numbers compared with their limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness, run as run_mod

LOW_BITS = 240
PATCHED = ("msm_affine_multi", "msm_affine")


def _low_bits(fn):
    def wrapper(x, y, scalar_limbs, *args, **kwargs):
        cut = scalar_limbs.clone()
        cut[LOW_BITS // 16:] = 0
        return fn(x, y, cut, *args, **kwargs)

    return wrapper


def run(bench, workload: str, seed: int, seconds: float, control: bool, build) -> dict:
    from snarkos_tpu_torch.ops import msm

    saved = {name: getattr(msm, name) for name in PATCHED}

    def patch(cell):
        for name, fn in saved.items():
            setattr(msm, name, _low_bits(fn))

    try:
        res = harness.run_cell(bench, workload, seed, seconds, False, "cuda", time.monotonic(),
                               patch=patch if control else None, build=build)
    finally:
        for name, fn in saved.items():
            setattr(msm, name, fn)
    return {"workload": workload, "seed": seed, "kind": "control" if control else "sound",
            "correct": res["correct"], "attempted": res["attempted"],
            "metrics": res["metrics"], "compared": res["compared"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    run_mod.prepare()
    bench = harness.Benchmark()
    config = bench.config(bench.workload(args.workload)["config"])
    driver = harness.load_file("drivers", config["driver"])
    built = {}

    def build(config, device):
        if "system" not in built:
            built["system"] = driver.build(config, device)
        return built["system"]

    for kind, seeds in (("sound", args.sound), ("control", args.control)):
        for seed in (int(s) for s in seeds.split(",") if s):
            out = run(bench, args.workload, seed, args.seconds, kind == "control", build)
            print(json.dumps(out), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"control: the process holds {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
