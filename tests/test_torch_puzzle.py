"""The slice as a whole: the port's puzzle prover (plain PyTorch on the CPU)
against the JAX package's Puzzle at degree 2^6 — the same SRS, the same
epoch tensors (also handed over through convert.py), the same coefficients,
and, in the slow tier, byte-identical solutions."""

import os

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto.ref import kzg as jref_kzg, poseidon as jref_poseidon
from snarkos_tpu.ops import puzzle as jpuzzle
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.ops import puzzle
from snarkos_tpu_torch.ops.fieldspec import FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

LOG_DEGREE = 6
EPOCH = b"\x02" * 32
ADDRESS = "aleo1prover"
NONCES = [11, 12, 13]


@pytest.fixture(scope="module")
def jax_puzzle():
    return jpuzzle.Puzzle(log_degree=LOG_DEGREE)


def _srs_arrays(jpz):
    return tuple(np.asarray(t) for t in (jpz.srs.points.x, jpz.srs.points.y, jpz.srs.points.z))


@pytest.fixture(scope="module")
def port_puzzle(jax_puzzle):
    """The port's Puzzle on the CPU, holding the JAX package's SRS."""
    srs = convert.puzzle_srs(*_srs_arrays(jax_puzzle), device="cpu")
    return puzzle.Puzzle(log_degree=LOG_DEGREE, device="cpu", srs=srs)


def _host_coeffs(jpz, nonce):
    """The JAX package's host reference of the coefficients (Poseidon
    leaves through EpochProgram.apply_host), as tests/test_puzzle.py."""
    seed = jpz._seed_field(EPOCH, ADDRESS, nonce)
    leaves = [jref_poseidon.hash_many([seed, i], rate=2, domain=jpuzzle.COEFF_DOMAIN)[0]
              for i in range(jpz.k)]
    return jpz.epoch_program(EPOCH).apply_host(leaves)


def _host_solution(jpz, nonce):
    coeffs = _host_coeffs(jpz, nonce)
    c_bytes = jpuzzle._g1_to_bytes(jref_kzg.commit(jpz.srs.srs_ref, coeffs))
    z = jpz._challenge(c_bytes)
    y, w_pt = jref_kzg.open_at(jpz.srs.srs_ref, coeffs, z)
    return (c_bytes, y, jpuzzle._g1_to_bytes(w_pt),
            jpuzzle.sha64(c_bytes, y.to_bytes(32, "little")))


def test_epoch_program_matches_jax(jax_puzzle):
    jprog = jax_puzzle.epoch_program(EPOCH)
    prog = puzzle.EpochProgram(EPOCH, jax_puzzle.k, device="cpu")
    via = convert.epoch_program(EPOCH, np.asarray(jprog.perms), np.asarray(jprog.sels),
                                np.asarray(jprog.consts), device="cpu")
    for name in ("perms", "sels", "consts"):
        want = np.asarray(getattr(jprog, name))
        for p in (prog, via):
            got = getattr(p, name)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    leaves = [i * 7 + 1 for i in range(jax_puzzle.k)]
    assert prog.apply_host(leaves) == jprog.apply_host(leaves)
    leaves_t = torch.from_numpy(np.ascontiguousarray(FR.encode_fast(leaves, mont=True)))
    got = prog.apply(leaves_t.reshape(FR.nlimbs, 1, -1))[:, 0]
    assert FR.decode_fast(got.numpy(), mont=True) == jprog.apply_host(leaves)


def test_dev_srs_matches_jax(jax_puzzle):
    """The port builds the dev SRS on the device (here, the plain versions);
    its first powers equal the JAX package's SRS limb for limb, and its host
    copy equals the JAX package's srs_ref."""
    srs = puzzle.PuzzleSRS.dev(log_degree=2, device="cpu")
    x, y, z = _srs_arrays(jax_puzzle)
    n = srs.degree + 1
    for got, want in zip((srs.points.x, srs.points.y, srs.points.z), (x, y, z)):
        np.testing.assert_array_equal(got.numpy(), want[:, :n])
    # the host copy the verifier reads: the decoded powers, H and DEV_TAU H
    want = jax_puzzle.srs.srs_ref
    assert srs.srs_ref.h == want.h and srs.srs_ref.tau_h == want.tau_h
    assert [tuple(p) for p in srs.srs_ref.powers_g1] == [tuple(p) for p in want.powers_g1[:n]]
    assert srs.is_dev


def test_coefficients_match_host_reference(jax_puzzle, port_puzzle):
    got = port_puzzle.coefficients(EPOCH, ADDRESS, NONCES)
    for i, nonce in enumerate(NONCES):
        assert FR.decode_fast(got[:, i].numpy(), mont=True) == _host_coeffs(jax_puzzle, nonce)


def test_host_pieces_match_jax(jax_puzzle, port_puzzle):
    c = b"\x05" * 97
    assert port_puzzle._challenge(c) == jax_puzzle._challenge(c)
    assert port_puzzle._seed_field(EPOCH, ADDRESS, 7) == jax_puzzle._seed_field(EPOCH, ADDRESS, 7)
    assert puzzle.sha64(b"a", b"b") == jpuzzle.sha64(b"a", b"b")
    p = jref_kzg.g1.scalar_mul(5, jref_kzg.g1.GENERATOR)
    assert puzzle._g1_to_bytes(p) == jpuzzle._g1_to_bytes(p)
    assert puzzle._g1_to_bytes(jref_kzg.g1.INFINITY) == jpuzzle._g1_to_bytes(jref_kzg.g1.INFINITY)
    assert puzzle.Puzzle.passes_target(0, 1)
    assert puzzle.Puzzle.passes_target((1 << 64) // 4, 4)
    assert not puzzle.Puzzle.passes_target((1 << 64) // 4 + 1, 4)


def test_convert_rejects_bad_state():
    z = np.zeros((24, 3), dtype=np.int32)
    with pytest.raises(ValueError, match="int32"):
        convert.points(z.astype(np.int64), z, z, device="cpu")
    with pytest.raises(ValueError, match="limbs"):
        convert.points(z[:16], z, z, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        convert.points(z + 0x10000, z, z, device="cpu")
    perms = np.tile(np.arange(4, dtype=np.int32), (puzzle.EPOCH_STEPS, 1))
    sels = np.zeros((puzzle.EPOCH_STEPS, 1, 4), dtype=np.int32)
    consts = np.zeros((puzzle.EPOCH_STEPS, 16, 4), dtype=np.int32)
    convert.epoch_program(EPOCH, perms, sels, consts, device="cpu")
    bad = perms.copy()
    bad[0, 0] = 1
    with pytest.raises(ValueError, match="permutation"):
        convert.epoch_program(EPOCH, bad, sels, consts, device="cpu")
    with pytest.raises(ValueError, match="selectors"):
        convert.epoch_program(EPOCH, perms, sels + 4, consts, device="cpu")


@pytest.mark.slow
def test_prove_batch_byte_identical_to_host_reference(jax_puzzle):
    """prove_batch over 3 nonces with the port's own dev SRS equals the JAX
    package's host reference byte for byte (about 3 minutes on a CPU)."""
    pz = puzzle.Puzzle(log_degree=LOG_DEGREE, device="cpu")
    sols = pz.prove_batch(EPOCH, ADDRESS, NONCES)
    for nonce, sol in zip(NONCES, sols):
        assert (sol.commitment, sol.eval_y, sol.witness, sol.solution_id) == \
            _host_solution(jax_puzzle, nonce)


@pytest.mark.slow
def test_prove_matches_jax_prove(jax_puzzle, port_puzzle):
    """The JAX package's own device prove() against the port. XLA:CPU takes
    hours and more than 15 GB to compile the JAX prove graph (Pallas in
    interpret mode): run it on a large host or on the TPU."""
    os.environ.setdefault("SNARKOS_TPU_PUZZLE_LOG_DEGREE", str(LOG_DEGREE))
    want = jax_puzzle.prove(EPOCH, ADDRESS, NONCES[0])
    assert port_puzzle.prove(EPOCH, ADDRESS, NONCES[0]) == puzzle.PuzzleSolutionData(
        commitment=want.commitment, eval_y=want.eval_y, witness=want.witness,
        solution_id=want.solution_id)
