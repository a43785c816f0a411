"""The plain reference against the golden fixtures of the repository (made
by the JAX package's host reference) and against the program run with
``device="cpu"`` (its kernels' plain versions) at small sizes."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from bench_support import ROOT

from benchmark.reference import bls12_377 as curve
from benchmark.reference import kzg as ref_kzg
from benchmark.reference import poseidon
from benchmark.reference import puzzle as ref

FIXTURES = os.path.join(ROOT, "tests", "fixtures")


@pytest.mark.parametrize("log_degree", [0, 1, 2, 3, 12])
def test_reference_matches_the_golden_solutions(log_degree):
    path = os.path.join(FIXTURES, f"torch_puzzle_k{log_degree}_b8.json")
    if not os.path.exists(path):
        pytest.skip(f"{path} is not in this checkout")
    with open(path) as fh:
        fx = json.load(fh)
    eh, k = bytes.fromhex(fx["epoch_hash"]), 1 << log_degree
    prog = ref.EpochProgram(eh, k)
    for s in fx["solutions"][:1 if log_degree == 12 else None]:
        got = ref.solution(prog, eh, fx["address"], s["nonce"], k)
        assert got["commitment"].hex() == s["commitment"]
        assert got["witness"].hex() == s["witness"]
        assert got["eval_y"] == int(s["eval_y"])
        assert got["solution_id"] == int(s["solution_id"])


def test_poseidon_parameters_match_the_program():
    from snarkos_tpu_torch.crypto.ref import poseidon as prog_poseidon

    assert poseidon.params(2) == tuple(prog_poseidon.poseidon_params(2))
    state = [3, 1, 4]
    assert poseidon.permute(state, 2) == prog_poseidon.permute(state, 2)


def test_reference_matches_the_program_prove_batch_on_cpu():
    from snarkos_tpu_torch.ops import puzzle

    p = puzzle.Puzzle(log_degree=0, device="cpu")
    eh, addr = bytes(range(32)), "aleo1reference"
    got = p.prove_batch(eh, addr, [2**63 + 5])[0]
    want = ref.solution(ref.EpochProgram(eh, 1), eh, addr, 2**63 + 5, 1)
    assert (got.commitment, got.eval_y, got.witness, got.solution_id) == (
        want["commitment"], want["eval_y"], want["witness"], want["solution_id"])


def test_reference_matches_the_program_coefficients_on_cpu():
    from snarkos_tpu_torch.ops import puzzle
    from snarkos_tpu_torch.ops.fieldspec import FR

    k, eh, addr, nonces = 16, b"\x07" * 32, "aleo1coeffs", [1, 2]
    p = puzzle.Puzzle.__new__(puzzle.Puzzle)
    p.device, p.k, p._programs = torch.device("cpu"), k, {}
    p._programs_lock = puzzle.threading.Lock()
    got = p.coefficients(eh, addr, nonces)
    prog = ref.EpochProgram(eh, k)
    for b, n in enumerate(nonces):
        want = prog.apply(ref.leaves(ref.seed_field(eh, addr, n), k))
        assert FR.decode_fast(got[:, b].numpy(), mont=True) == want


def test_reference_matches_the_commit_cell_on_cpu():
    """The commit cell's own system on the CPU: its SRS built by the
    program's group arithmetic, its commit through ``ops/kzg.commit``."""
    from benchmark import harness

    driver = harness.load_file("drivers", "kzg_commit")
    config = {"log_degree": 2, "tau_exponent": 3735928559, "check_sample": 2}
    system = driver.build(config, "cpu")
    cell = driver.Cell(system, config, {"pool": 2}, 2**31 + 9)
    for i in range(2):
        got = cell.call(i)
        want = ref_kzg.commitment(cell.pool[i].numpy(), system.tau)
        assert curve.to_bytes(got) == want


def test_kzg_reference_is_p_of_tau_times_g():
    rng = np.random.default_rng(3)
    limbs = rng.integers(0, 1 << 16, size=(16, 5))
    limbs[15] &= 0xFFF
    tau = 12345
    vals = curve.fr_from_limbs(limbs, mont=True)
    acc = curve.INFINITY
    for i, v in enumerate(vals):
        acc = curve.add(acc, curve.mul(v * pow(tau, i, curve.R)))
    assert ref_kzg.commitment(limbs, tau) == curve.to_bytes(acc)
