"""The verifier half of the port on the CPU against the JAX package at degree
2^6, with the JAX package's SRS (points and tau H) handed over through
convert.py: check_structural and check_binding, kzg.verify and
kzg.batch_verify (valid, tampered-y, swapped-witness and identity-witness
openings) against crypto/ref/kzg.py, and Puzzle.verify / verify_batch on
solutions built by the JAX package's host reference.

A tier-1 test runs at most two pairing checks (pure Python, ~1.2 s each
on a CPU). batch_verify's device MSMs in plain PyTorch take tens of seconds on a
CPU: tier 1 checks its composition with the MSM replaced by a host sum, the
slow tier runs the real one."""

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto.ref import g1 as jref_g1, kzg as jref_kzg, poseidon as jref_poseidon
from snarkos_tpu.ops import puzzle as jpuzzle
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1 as ref_g1
from snarkos_tpu_torch.ops import g1, kzg, puzzle
from snarkos_tpu_torch.ops.fieldspec import FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

LOG_DEGREE = 6
EPOCH = b"\x03" * 32
ADDRESS = "aleo1verifier"
NONCES = [21, 22]
R = params.FR_MODULUS


@pytest.fixture(scope="module")
def jax_puzzle():
    return jpuzzle.Puzzle(log_degree=LOG_DEGREE)


@pytest.fixture(scope="module")
def port_puzzle(jax_puzzle):
    s = jax_puzzle.srs
    srs = convert.puzzle_srs(*(np.asarray(t) for t in (s.points.x, s.points.y, s.points.z)),
                             tau_h=s.srs_ref.tau_h, is_dev=s.is_dev, device="cpu")
    return puzzle.Puzzle(log_degree=LOG_DEGREE, device="cpu", srs=srs)


@pytest.fixture(scope="module")
def solutions(jax_puzzle):
    """(commitment, eval_y, witness) of each nonce from the JAX package's
    host reference (Poseidon leaves through EpochProgram.apply_host, host
    commit and open)."""
    out = []
    for nonce in NONCES:
        seed = jax_puzzle._seed_field(EPOCH, ADDRESS, nonce)
        leaves = [jref_poseidon.hash_many([seed, i], rate=2, domain=jpuzzle.COEFF_DOMAIN)[0]
                  for i in range(jax_puzzle.k)]
        coeffs = jax_puzzle.epoch_program(EPOCH).apply_host(leaves)
        c_bytes = jpuzzle._g1_to_bytes(jref_kzg.commit(jax_puzzle.srs.srs_ref, coeffs))
        y, w_pt = jref_kzg.open_at(jax_puzzle.srs.srs_ref, coeffs, jax_puzzle._challenge(c_bytes))
        out.append((c_bytes, y, jpuzzle._g1_to_bytes(w_pt)))
    return out


def _openings(jax_puzzle, solutions):
    """(C, z, y, W) openings of the solutions, plus a constant polynomial's
    (C = 7 G, W = the identity)."""
    ops = [jax_puzzle.check_structural(c, y, w, 1) for c, y, w in solutions]
    const = (jref_g1.scalar_mul(7, jref_g1.GENERATOR), 12345, 7, jref_g1.INFINITY)
    return ops, const


def test_convert_carries_the_srs(jax_puzzle, port_puzzle):
    got, want = port_puzzle.srs, jax_puzzle.srs
    assert got.srs_ref.tau_h == want.srs_ref.tau_h and got.srs_ref.h == want.srs_ref.h
    assert [tuple(p) for p in got.srs_ref.powers_g1] == [tuple(p) for p in want.srs_ref.powers_g1]
    assert got.is_dev and got.degree == want.degree
    with pytest.raises(ValueError, match="tau_h"):
        convert.puzzle_srs(*(np.asarray(t) for t in (want.points.x, want.points.y,
                                                      want.points.z)),
                           tau_h=((1, 2), (3, 4)), device="cpu")


def test_check_structural_matches_jax(jax_puzzle, port_puzzle, solutions):
    c, y, w = solutions[0]
    q = params.FQ_MODULUS
    x_ge_q = q.to_bytes(48, "little") + c[48:]
    off_curve = c[:48] + ((int.from_bytes(c[48:96], "little") + 1) % q).to_bytes(48, "little") + b"\x00"
    identity = b"\x00" * 96 + b"\x01"
    cases = [(c, y, w, 1), (x_ge_q, y, w, 1), (c, y, x_ge_q, 1), (c[:96], y, w, 1),
             (off_curve, y, w, 1), (c, R, w, 1), (c, -1, w, 1), (c, y, identity, 1),
             (identity, y, w, 1), (c, y, w, 1 << 64)]
    for args in cases:
        assert port_puzzle.check_structural(*args) == jax_puzzle.check_structural(*args)
    assert port_puzzle.check_structural(x_ge_q, y, w, 1) is None
    assert port_puzzle.check_structural(c, y, identity, 1)[3] == ref_g1.INFINITY


def test_check_binding_matches_host_reference(port_puzzle, solutions):
    """The device re-derivation (Poseidon, 12 epoch steps, poly_eval) accepts
    the host reference's eval_y and rejects eval_y + 1 (the JAX package's
    device check_binding takes ~30 s to compile here: slow tier)."""
    c, y, _ = solutions[0]
    assert port_puzzle.check_binding(EPOCH, ADDRESS, NONCES[0], c, y)
    assert not port_puzzle.check_binding(EPOCH, ADDRESS, NONCES[0], c, (y + 1) % R)


def test_kzg_verify_matches_ref(jax_puzzle, port_puzzle, solutions):
    """One host pairing check (the tampered openings: the slow tier)."""
    ops, _ = _openings(jax_puzzle, solutions)
    assert kzg.verify(port_puzzle.srs.srs_ref, *ops[0])
    assert jref_kzg.verify(jax_puzzle.srs.srs_ref, *ops[0])


def _host_msm(points, scalar_limbs):
    """A host stand-in for msm.msm: sum k_i P_i over the decoded bases."""
    pts = g1.decode_points(points)
    ks = FR.decode_fast(scalar_limbs.numpy())
    acc = ref_g1.INFINITY
    for k, p in zip(ks, pts):
        acc = ref_g1.add(acc, ref_g1.scalar_mul(k, p))
    return g1.encode_points([acc])


def test_batch_verify_composition(jax_puzzle, port_puzzle, solutions, monkeypatch):
    """kzg.batch_verify's coefficients, padding and pairing equation, with the
    device MSM replaced by a host sum: the openings plus an identity-witness
    opening verify, and with the witnesses swapped they do not, as in
    crypto/ref/kzg.batch_verify (the real MSMs: the slow tier)."""
    calls = []

    def spy(points, scalar_limbs):
        calls.append(points.x.shape[-1])
        return _host_msm(points, scalar_limbs)

    monkeypatch.setattr(kzg.msm_mod, "msm", spy)
    ops, const = _openings(jax_puzzle, solutions)
    srs = port_puzzle.srs.srs_ref
    good = ops + [const]
    assert kzg.batch_verify(srs, good, device="cpu")
    assert calls == [8, 8]  # 2 b + 1 = 7 and b = 3 bases, padded to 8
    swapped = [(ops[0][0], ops[0][1], ops[0][2], ops[1][3]),
               (ops[1][0], ops[1][1], ops[1][2], ops[0][3])]
    assert not kzg.batch_verify(srs, swapped, device="cpu")
    assert not jref_kzg.batch_verify(jax_puzzle.srs.srs_ref, swapped)
    assert jref_kzg.batch_verify(jax_puzzle.srs.srs_ref, good)
    assert kzg.batch_verify(srs, [], device="cpu")


def test_verify_batch_early_rejects(port_puzzle, solutions):
    """verify_batch checks each item before any pairing and stops at the
    first failure: a target miss, a bad encoding, a wrong eval_y."""
    (c, y, w), (c2, y2, w2) = solutions
    item = (EPOCH, ADDRESS, NONCES[0], c, y, w, 1)
    assert port_puzzle.verify_batch([])
    assert not port_puzzle.verify_batch([item, (EPOCH, ADDRESS, NONCES[1], c2, y2, w2, 1 << 64)])
    assert not port_puzzle.verify_batch([(EPOCH, ADDRESS, NONCES[0], c[:96], y, w, 1), item])
    assert not port_puzzle.verify_batch([(EPOCH, ADDRESS, NONCES[0], c, (y + 1) % R, w, 1)])


@pytest.mark.slow
def test_kzg_verify_rejects_like_ref(jax_puzzle, port_puzzle, solutions):
    """Tampered y, a swapped witness, and the identity-witness opening."""
    ops, const = _openings(jax_puzzle, solutions)
    c_pt, z, y, w_pt = ops[0]
    for case in ((c_pt, z, (y + 1) % R, w_pt), (c_pt, z, y, ops[1][3]), const,
                 (const[0], const[1], 8, const[3])):
        assert kzg.verify(port_puzzle.srs.srs_ref, *case) == \
            jref_kzg.verify(jax_puzzle.srs.srs_ref, *case)


@pytest.mark.slow
def test_check_binding_matches_jax_device(jax_puzzle, port_puzzle, solutions):
    c, y, _ = solutions[1]
    for nonce, yy in ((NONCES[1], y), (NONCES[1], (y + 1) % R), (NONCES[0], y)):
        assert port_puzzle.check_binding(EPOCH, ADDRESS, nonce, c, yy) == \
            jax_puzzle.check_binding(EPOCH, ADDRESS, nonce, c, yy)


@pytest.mark.slow
def test_batch_verify_on_the_engines(jax_puzzle, port_puzzle, solutions):
    """The real device MSMs (plain versions): affine openings on the fused
    engine, with the identity-witness opening on the generic one; tampered y
    and swapped witnesses rejected, each as crypto/ref/kzg.batch_verify."""
    ops, const = _openings(jax_puzzle, solutions)
    srs, jsrs = port_puzzle.srs.srs_ref, jax_puzzle.srs.srs_ref
    tampered = ops[:1] + [(ops[1][0], ops[1][1], (ops[1][2] + 1) % R, ops[1][3])]
    swapped = [(ops[0][0], ops[0][1], ops[0][2], ops[1][3]),
               (ops[1][0], ops[1][1], ops[1][2], ops[0][3])]
    const_bad = (const[0], const[1], 8, const[3])
    for case in (ops, ops + [const], tampered, swapped, ops + [const_bad]):
        assert kzg.batch_verify(srs, case, device="cpu") == jref_kzg.batch_verify(jsrs, case)


@pytest.mark.slow
def test_verify_and_verify_batch(port_puzzle, solutions):
    """Puzzle.verify accepts each host-reference solution; verify_batch
    accepts both and rejects them with the witnesses swapped."""
    items = [(EPOCH, ADDRESS, n, c, y, w, 1) for n, (c, y, w) in zip(NONCES, solutions)]
    for item in items:
        assert port_puzzle.verify(*item)
    assert port_puzzle.verify_batch(items)
    assert port_puzzle.verify_batch(items[:1])
    swapped = [items[0][:5] + (items[1][5], 1), items[1][:5] + (items[0][5], 1)]
    assert not port_puzzle.verify_batch(swapped)
