"""A run of each cell with the timed path broken underneath comes out not
correct: the harness's look for a card skipped, the plain reference put in
the program's place at a size the CPU holds, and each fault the cell can
have planted in it. The sound run beside them comes out correct.

The faults: half of each batch left out (the prover returns solutions for
the first half of its nonces; the commit sums the lower half of the
coefficients), and an answer altered where it is produced (a commitment's
byte, an eval_y, in every answer; a commitment's byte in one slot of every
batch: the check samples one answer of every slot). One card
holds each cell, so there is no exchange between chips to leave out; no
cell trains, so no step returns its state. The
control, the reference in a lower precision than the configuration states
(the MSM's scalars cut to their low 240 bits), comes out not correct too.
"""

from __future__ import annotations

import dataclasses
import time

import pytest
from bench_support import ReferenceCommitter, ReferenceProver, Solution, bench_copy

from benchmark import harness
from benchmark.reference import bls12_377 as curve
from benchmark.reference import puzzle as ref_puzzle

SMALL = {"puzzle-k12": {"log_degree": 2},
         "kzg-k20": {"log_degree": 4, "check_sample": 3}}


def _run(tmp_path, workload, patch=None):
    bench = harness.Benchmark(bench_copy(tmp_path, SMALL))
    config = bench.config(bench.workload(workload)["config"])

    def build(config, device):
        if config["driver"] == "puzzle":
            return ReferenceProver(config["log_degree"])
        return ReferenceCommitter(config)

    return harness.run_cell(bench, workload, 2**31 + 77, 0.3, False, "cpu",
                            time.monotonic(), patch=patch, build=build), config


def _prove_half(cell):
    orig = cell.system.prove_batch
    cell.system.prove_batch = lambda e, a, nonces, t=None: orig(e, a, nonces[:len(nonces) // 2])


def _prove_altered(cell):
    orig = cell.system.prove_batch

    def altered(e, a, nonces, t=None):
        return [dataclasses.replace(s, commitment=s.commitment[:5] + bytes([s.commitment[5] ^ 1])
                                    + s.commitment[6:]) for s in orig(e, a, nonces)]

    cell.system.prove_batch = altered


def _prove_last_slot_altered(cell):
    orig = cell.system.prove_batch

    def altered(e, a, nonces, t=None):
        sols = orig(e, a, nonces)
        c = sols[-1].commitment
        sols[-1] = dataclasses.replace(sols[-1], commitment=c[:5] + bytes([c[5] ^ 1]) + c[6:])
        return sols

    cell.system.prove_batch = altered


def _prove_y_altered(cell):
    orig = cell.system.prove_batch
    cell.system.prove_batch = lambda e, a, nonces, t=None: [
        dataclasses.replace(s, eval_y=(s.eval_y + 1) % curve.R) for s in orig(e, a, nonces)]


def _commit_half(cell):
    orig = cell.system.commit

    def half(coeffs):
        low = coeffs.clone()
        low[:, low.shape[1] // 2:] = 0
        return orig(low)

    cell.system.commit = half


def _commit_altered(cell):
    orig = cell.system.commit
    cell.system.commit = lambda coeffs: curve.add(orig(coeffs), curve.GENERATOR)


def _control_prover(cell):
    """The control: the reference with each coefficient cut to its low 240
    bits before the commitment, as an MSM over shorter scalars computes."""
    k = cell.system.k
    mask = (1 << 240) - 1

    def prove_batch(e, a, nonces, t=None):
        prog = ref_puzzle.EpochProgram(e, k)
        out = []
        for n in nonces:
            p = prog.apply(ref_puzzle.leaves(ref_puzzle.seed_field(e, a, n), k))
            c = curve.to_bytes(curve.mul(ref_puzzle.evaluate([x & mask for x in p],
                                                             ref_puzzle.DEV_TAU)))
            s = ref_puzzle.solution(prog, e, a, n, k)
            out.append(Solution(c, s["eval_y"], s["witness"], s["solution_id"]))
        return out

    cell.system.prove_batch = prove_batch


def _control_commit(cell):
    tau, mask = cell.system.tau, (1 << 240) - 1

    def commit(coeffs):
        vals = curve.fr_from_limbs(coeffs.numpy(), mont=True)
        return curve.mul(ref_puzzle.evaluate([v & mask for v in vals], tau))

    cell.system.commit = commit


@pytest.mark.parametrize("workload", ["prover-b8", "kzg-commit-k20"])
def test_sound_run_is_correct(tmp_path, workload):
    res, _ = _run(tmp_path, workload)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["compared"].values())


@pytest.mark.parametrize("workload,fault", [
    ("prover-b8", _prove_half), ("prover-b8", _prove_altered), ("prover-b8", _prove_y_altered),
    ("prover-b8", _prove_last_slot_altered), ("prover-b16", _prove_last_slot_altered),
    ("prover-b16", _prove_half), ("kzg-commit-k20", _commit_half),
    ("kzg-commit-k20", _commit_altered)])
def test_fault_is_not_correct(tmp_path, workload, fault):
    res, _ = _run(tmp_path, workload, patch=fault)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("workload,control", [
    ("prover-b8", _control_prover), ("kzg-commit-k20", _control_commit)])
def test_control_is_not_correct(tmp_path, workload, control):
    res, _ = _run(tmp_path, workload, patch=control)
    assert not res["correct"]
    assert res["compared"]["mismatched"]["value"] == res["compared"]["mismatched"]["sampled"] > 0


def test_failed_request_is_not_correct(tmp_path):
    def raise_on_third(cell):
        orig = cell.call
        cell.call = lambda i: orig(i) if i < 2 else (_ for _ in ()).throw(RuntimeError("700"))

    res, _ = _run(tmp_path, "kzg-commit-k20", patch=raise_on_third)
    assert not res["correct"] and res["failed"] == 1
