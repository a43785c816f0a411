"""Helpers of the benchmark's tests: a copy of the benchmark to change, and
the plain reference put in the program's place."""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass

from benchmark.reference import bls12_377 as curve
from benchmark.reference import puzzle as ref_puzzle

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_copy(tmp_path, configs: dict | None = None) -> str:
    """A copy of BENCHMARK.json and benchmark/ under tmp_path, with the
    given configuration files' keys replaced (``{config name: {key:
    value}}``); returns the copy's root."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for c in spec["configs"]:
        if c["name"] in (configs or {}):
            path = os.path.join(root, c["file"])
            with open(path) as fh:
                data = json.load(fh)
            data.update(configs[c["name"]])
            with open(path, "w") as fh:
                json.dump(data, fh)
    return root


@dataclass(frozen=True)
class Solution:
    commitment: bytes
    eval_y: int
    witness: bytes
    solution_id: int


class ReferenceProver:
    """The reference in the program's place: ``prove_batch`` of the
    puzzle's plain reference at log degree ``log_degree`` on the CPU."""

    def __init__(self, log_degree: int):
        import torch

        self.device = torch.device("cpu")
        self.k = 1 << log_degree
        self.programs = {}

    def prove_batch(self, epoch_hash, address, nonces, proof_target=None):
        prog = self.programs.setdefault(epoch_hash, ref_puzzle.EpochProgram(epoch_hash, self.k))
        out = []
        for n in nonces:
            s = ref_puzzle.solution(prog, epoch_hash, address, n, self.k)
            out.append(Solution(s["commitment"], s["eval_y"], s["witness"], s["solution_id"]))
        return out


class ReferenceCommitter:
    """The reference in the program's place for the commit cell: p(tau) G
    as a Jacobian tuple, on the CPU."""

    def __init__(self, config: dict):
        import torch

        self.device = torch.device("cpu")
        self.n = 1 << config["log_degree"]
        self.tau = pow(22, config["tau_exponent"], curve.R)

    def commit(self, coeffs_mont):
        limbs = coeffs_mont.numpy()
        vals = curve.fr_from_limbs(limbs, mont=True)
        return curve.mul(ref_puzzle.evaluate(vals, self.tau))
