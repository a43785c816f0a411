"""The port's Varuna (snarkos_tpu_torch/crypto/ref/varuna.py, r1cs.py)
against the JAX package's on the CPU: the same authorization circuit and
witness, the same openings from ``verify_prepare`` on the golden chain's
proofs (tests/fixtures/torch_ledger_dev4.json, made by the JAX ledger), the
same verdict on a tampered proof, and, for a circuit of degree 512, a proof
byte for byte equal to the JAX prover's with the same mask seed. Field
values, bytes and affine points are compared exactly.

The commitments of the port's index and prover go through
``torch_node_support.tau_commit`` (p(tau) G at the known dev tau); ``-m
slow`` proves through the ledger's ``device_commit`` on the CPU (the plain
MSM engine)."""

import dataclasses
import hashlib

import pytest

from snarkos_tpu.crypto.ref import r1cs as jr1cs, varuna as jvaruna
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.crypto.ref import r1cs, varuna
from snarkos_tpu_torch.node import ledger, types
from snarkos_tpu_torch.vm import circuit

import torch_node_support as sup

R = varuna.R


def _rows(cs):
    return [[list(r.items()) for r in rows] for rows in (cs.rows_a, cs.rows_b, cs.rows_c)]


def test_auth_circuit_same():
    cs, kv = r1cs.auth_circuit()
    jcs, jkv = jr1cs.auth_circuit()
    assert (cs.n, cs.num_public, kv) == (jcs.n, jcs.num_public, jkv)
    assert _rows(cs) == _rows(jcs)
    assert varuna.required_srs_degree(cs) == jvaruna.required_srs_degree(jcs) == 4096
    k, m = 0x1234_5678_9ABC, 0xFEDC_BA98
    t = r1cs.auth_statement(k, m)
    assert t == jr1cs.auth_statement(k, m)
    assert r1cs.auth_assignment(cs, kv, k, m, t) == jr1cs.auth_assignment(jcs, jkv, k, m, t)
    assert cs.digest() == r1cs.auth_circuit()[0].digest()


@pytest.fixture(scope="module")
def auth():
    cs, _ = r1cs.auth_circuit()
    srs = sup.tau_srs(varuna.required_srs_degree(cs))
    index = varuna.get_index(srs.srs_ref, cs, sup.tau_commit(srs))
    return cs, srs, index


def _auth_cases():
    """(block, transmission index, opening offset) of every transaction's
    authorization proof in the golden chain."""
    doc = sup.fixture()
    out = []
    for b, raw in enumerate(doc["blocks"]):
        blk = convert.block(bytes.fromhex(raw))
        off = 0
        for i, t in enumerate(blk.transmissions):
            obj = t.deserialize()
            if isinstance(obj, types.Solution):
                off += 1
                continue
            out.append((b, i, off))
            off += 2 + (2 if obj.exec_proof else 0)
    return out


@pytest.mark.parametrize("case", _auth_cases(), ids=lambda c: f"block{c[0] + 1}-tx{c[1]}")
def test_verify_prepare_matches_jax_openings(auth, case):
    cs, srs, index = auth
    b, i, off = case
    doc = sup.fixture()
    tx = convert.block(bytes.fromhex(doc["blocks"][b])).transmissions[i].deserialize()
    proof = varuna.VarunaProof.deserialize(tx.proof)
    publics = [1, ledger.transaction_binding(tx.payload, tx.fee), tx.auth_tag, 0]
    ops = varuna.verify_prepare(cs, publics, proof, srs=srs.srs_ref, index=index)
    assert ops is not None
    assert sup.openings_json(ops) == doc["openings"][b][off:off + 2]
    assert proof.serialize() == tx.proof


def test_tampered_proof_rejected_by_both(auth):
    cs, srs, index = auth
    b, i, _ = _auth_cases()[0]
    tx = convert.block(bytes.fromhex(sup.fixture()["blocks"][b])).transmissions[i].deserialize()
    publics = [1, ledger.transaction_binding(tx.payload, tx.fee), tx.auth_tag, 0]
    proof = varuna.VarunaProof.deserialize(tx.proof)
    jproof = jvaruna.VarunaProof.deserialize(tx.proof)
    jcs, _ = jr1cs.auth_circuit()
    good_p = varuna.verify_prepare(cs, publics, proof, srs=srs.srs_ref, index=index)
    good_j = jvaruna.verify_prepare(jcs, publics, jproof, srs=srs.srs_ref, index=index)
    assert sup.openings_json(good_p) == sup.openings_json(good_j)
    for slot in (0, 9, 25):  # an eval at beta, at delta, the last one
        evals = list(proof.evals)
        evals[slot] = (evals[slot] + 1) % R
        bad = dataclasses.replace(proof, evals=evals)
        jbad = dataclasses.replace(jproof, evals=evals)
        assert varuna.verify_prepare(cs, publics, bad, srs=srs.srs_ref, index=index) is None
        assert jvaruna.verify_prepare(jcs, publics, jbad, srs=srs.srs_ref, index=index) is None
    wrong = [1, publics[1], (publics[2] + 1) % R, 0]  # another tag
    assert varuna.verify_prepare(cs, wrong, proof, srs=srs.srs_ref, index=index) is None
    assert jvaruna.verify_prepare(jcs, wrong, jproof, srs=srs.srs_ref, index=index) is None
    with pytest.raises(Exception):
        varuna.VarunaProof.deserialize(tx.proof[:-1])


def test_index_cache_keyed_by_content(auth):
    """Two equal systems and two equal SRS objects share one cached index;
    another SRS length or another system does not."""
    cs, srs, index = auth
    cs2, _ = r1cs.auth_circuit()
    srs2 = sup.tau_srs(srs.degree)
    assert cs2 is not cs and srs2.srs_ref is not srs.srs_ref

    def boom(_coeffs):
        raise AssertionError("the cached index was recomputed")

    assert varuna.get_index(srs2.srs_ref, cs2, boom) is index
    assert varuna.srs_tag(sup.tau_srs(srs.degree + 1).srs_ref) != varuna.srs_tag(srs.srs_ref)
    cs2.enforce({cs2.one: 1}, {cs2.one: 1}, {cs2.one: 1})
    assert cs2.digest() != cs.digest()


def _transfer_case():
    """The golden chain's credits.aleo/transfer_public (block 1): its
    transaction, key and arguments."""
    doc = sup.fixture()
    blk = convert.block(bytes.fromhex(doc["blocks"][0]))
    tx = next(t.deserialize() for t in blk.transmissions
              if t.kind == types.TX_TRANSACTION and b"transfer_public" in t.deserialize().payload)
    return tx, int(doc["keys"]["transfer"], 16)


def _prove_transfer(commit_fn, srs):
    """The port's Varuna prover on the transfer's execution circuit (degree
    512), with the witness and the mask seed the JAX ledger derived from the
    transaction's key and payload (node/ledger.py prove_execution)."""
    tx, key = _transfer_case()
    program_id, fn_name, caller, _sig, toks = ledger._parse_execute_payload(tx.payload)
    prog = ledger.credits_program()
    args = [ledger._parse_payload_value(prog, t, ty)
            for t, (_r, ty, _v) in zip(toks, prog.functions[fn_name].inputs)]
    blind = hashlib.sha256(b"snarkos_tpu.exec.blind" + key.to_bytes(32, "little")
                           + tx.payload).digest()
    circ, z, _pub = circuit.trace_execution(prog, fn_name, args, ledger._address_field(caller),
                                            blind)
    assert varuna.required_srs_degree(circ.cs) == srs.degree == 512
    seed = hashlib.sha256(b"snarkos_tpu.exec.mask" + key.to_bytes(32, "little")
                          + tx.payload).digest()
    proof = varuna.prove(srs.srs_ref, circ.cs, z, commit_fn=commit_fn, mask_seed=seed)
    return proof.serialize(), tx.exec_proof


def test_prove_matches_jax_bytes():
    """The transfer's execution proof, proved by the port with the JAX
    ledger's mask seed, equals the JAX proof in the golden chain byte for
    byte."""
    srs = sup.tau_srs(512)
    got, want = _prove_transfer(sup.tau_commit(srs), srs)
    assert got == want


@pytest.mark.slow
def test_prove_through_device_commit_on_cpu():
    """The same proof with the SRS built by ``PuzzleSRS.dev_powers`` and every
    commitment through the ledger's ``device_commit`` (ops/kzg.commit, the
    plain MSM engine on the CPU: ~28 MSMs of <= 513 points)."""
    from snarkos_tpu_torch.ops.puzzle import PuzzleSRS

    srs = PuzzleSRS.dev_powers(512, "cpu")
    assert [srs.srs_ref.powers_g1[i] for i in (0, 1, 512)] == [
        sup.tau_power(i) for i in (0, 1, 512)]
    varuna._INDEX_CACHE.clear()
    got, want = _prove_transfer(ledger.device_commit(srs), srs)
    assert got == want
