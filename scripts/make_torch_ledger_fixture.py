"""Golden ledger chain for the PyTorch port's tests and chip check.

Runs the JAX package's ledger on the host (its pure-Python Varuna prover,
the native MSM and Poseidon engines, the host KZG batch) at the node's real
settings: the dev committee of 4 validators, puzzle log degree 12, up to
``MAX_SOLUTIONS_PER_BLOCK`` = 4 solutions a block and the credits.aleo
genesis deploy. It builds, with fixed keys:

  block 1  4 solutions (epoch of block 0, found by a nonce search with the
           host prover pipeline of scripts/make_torch_puzzle_fixture.py), a
           credits.aleo/transfer_public execute with a fee, a deploy of a
           small program with a finalize and an execute of it in the same
           block;
  block 2  a credits.aleo/transfer_public_to_private (an execution SRS of
           degree 16,384);

each from a subdag whose anchor certificate the committee signs, through
``Ledger.prepare_advance_to_next_quorum_block``, checked by
``check_next_block`` and applied by ``advance_to_next_block``. It writes
tests/fixtures/torch_ledger_dev4.json: the committee's and the blocks' bytes,
each block's KZG openings (C, z, y, W; points as affine ints) and state root
after it, the sha256 of the execution SRSs' powers (``srs_digest``), the JAX
verdicts of ``check_solution_basic`` on block 1's solutions and a tampered
one, and tampered variants of block 1 with the JAX ledger's verdict on each:
a solution's eval_y + 1, forged exec_outs, a garbage execution proof.

    python scripts/make_torch_ledger_fixture.py [--workers N] [out.json]

The nonce search runs in N processes (default 4). The run time is in
CHANGES.md; the JAX ledger's SRS and verifying-key caches under .cache/
make later runs faster.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
import multiprocessing

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from snarkos_tpu.crypto import params  # noqa: E402
from snarkos_tpu.crypto.ref import g1 as ref_g1, ntt as ref_ntt, poseidon as ref_poseidon  # noqa: E402
from snarkos_tpu.node import ledger as L, types  # noqa: E402
from snarkos_tpu.node.cli import dev_account, dev_committee  # noqa: E402
from snarkos_tpu.ops.puzzle import COEFF_DOMAIN, EpochProgram, Puzzle, _g1_to_bytes, sha64  # noqa: E402
from snarkos_tpu.vm import values as V  # noqa: E402

R = params.FR_MODULUS
LOG_DEGREE = 12
NUM_VALIDATORS = 4
TAU = pow(params.FR_GENERATOR, 0xDEADBEEF, R)  # the dev SRS's, ops/puzzle.py
T0 = 1_760_000_000  # the certificates' timestamps are T0 + round
KEYS = {"transfer": 0x7472_616E_7366_6572, "deploy": 0x6465_706C_6F79, "bump": 0x6275_6D70,
        "to_private": 0x7072_6976}  # the transactions' authorization keys

TALLY_SRC = """program tally.aleo;

mapping tally:
    key as u64.public;
    value as u64.public;

function bump:
    input r0 as u64.public;
    async bump r0 into r1;
    output r1 as tally.aleo/bump.future;

finalize bump:
    input r0 as u64.public;
    get.or_use tally[r0] 0u64 into r1;
    add r1 1u64 into r2;
    set r2 into tally[r0];
"""


def _solution_row(args):
    """(epoch, address, nonce) -> the solution's fields, or None when it
    misses the target (the host prover pipeline at the dev tau)."""
    epoch_hash, address, nonce, target = args
    k = 1 << LOG_DEGREE
    prog = _program(epoch_hash)
    seed = Puzzle._seed_field(None, epoch_hash, address, nonce)
    leaves = [ref_poseidon.hash_many([seed, i], rate=2, domain=COEFF_DOMAIN)[0]
              for i in range(k)]
    coeffs = prog.apply_host(leaves)
    p_tau = ref_ntt.poly_eval(coeffs, TAU)
    c_bytes = _g1_to_bytes(ref_g1.scalar_mul(p_tau, ref_g1.GENERATOR))
    z = Puzzle._challenge(None, c_bytes)
    y = ref_ntt.poly_eval(coeffs, z)
    if not Puzzle.passes_target(sha64(c_bytes, y.to_bytes(32, "little")), target):
        return None
    q_tau = (p_tau - y) * pow(TAU - z, -1, R) % R
    w_bytes = _g1_to_bytes(ref_g1.scalar_mul(q_tau, ref_g1.GENERATOR))
    return types.Solution(epoch_hash=epoch_hash, address=address, nonce=nonce,
                          commitment=c_bytes, eval_y=y, witness=w_bytes)


_PROGRAMS = {}


def _program(epoch_hash):
    if epoch_hash not in _PROGRAMS:
        _PROGRAMS[epoch_hash] = EpochProgram(epoch_hash, 1 << LOG_DEGREE)
    return _PROGRAMS[epoch_hash]


def find_solutions(epoch_hash, address, target, count, workers):
    found, start, step = [], 0, 64 * workers
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        while len(found) < count:
            rows = pool.map(_solution_row, [(epoch_hash, address, n, target)
                                            for n in range(start, start + step)])
            found += [s for s in rows if s is not None]
            start += step
    return found[:count]


def subdag(committee, anchor_round, tids):
    """One anchor certificate by the round's leader over ``tids``, endorsed
    by every other validator (a quorum of the dev committee)."""
    accounts = {a.address: a for a in (dev_account(i) for i in range(NUM_VALIDATORS))}
    leader = accounts[committee.get_leader(anchor_round)]
    hdr = types.BatchHeader.sign_new(leader, anchor_round, T0 + anchor_round, committee.id,
                                     tids, ())
    sigs = tuple((addr, _sign(a, hdr.batch_id))
                 for addr, a in sorted(accounts.items()) if addr != leader.address)
    cert = types.BatchCertificate(batch_header=hdr, signatures=sigs)
    return types.Subdag(rounds=((anchor_round, (cert,)),))


def _sign(account, msg):
    from snarkos_tpu.crypto.ref import edwards

    return edwards.sign_bytes(account.sk, account.pk, msg)


def block_from(ledger, anchor_round, transmissions):
    tms = [t if isinstance(t, types.Transmission) else
           types.Transmission.from_solution(t) if isinstance(t, types.Solution) else
           types.Transmission.from_transaction(t) for t in transmissions]
    sub = subdag(ledger.committee_lookback_for_round(anchor_round), anchor_round,
                 [t.id for t in tms])
    return ledger.prepare_advance_to_next_quorum_block(sub, tms)


def _affine(p):
    a = ref_g1.affine(p)
    return None if a is None else [str(a[0]), str(a[1])]


def openings_of(ledger, block):
    """The block's KZG openings in check_next_block's order (the JAX
    ledger's own functions, with its overlay registry)."""
    from snarkos_tpu import vm as avm

    overlay = dict(ledger.parsed_programs)
    out = []
    for t in block.transmissions:
        obj = t.deserialize()
        if isinstance(obj, types.Solution):
            ops = [ledger._solution_opening_for(obj, block)]
        else:
            ops = L.transaction_opening(obj, overlay)
            if obj.is_deploy and L._is_program_source(obj.payload):
                prog = avm.parse_program(obj.payload.decode())
                overlay.setdefault(prog.id, prog)
        out += [{"C": _affine(c), "z": str(z), "y": str(y), "W": _affine(w)}
                for c, z, y, w in ops]
    return out


def verdict(fn):
    try:
        fn()
    except ValueError as exc:
        return {"accepted": False, "error": str(exc)}
    return {"accepted": True, "error": None}


def srs_digest(srs) -> str:
    h = hashlib.sha256()
    for p in srs.powers_g1:
        x, y = ref_g1.affine(p)
        h.update(x.to_bytes(48, "little") + y.to_bytes(48, "little"))
    return h.hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("out", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests", "fixtures",
        "torch_ledger_dev4.json"))
    args = ap.parse_args()
    os.environ["SNARKOS_TPU_PUZZLE_LOG_DEGREE"] = str(LOG_DEGREE)
    t0 = time.time()
    times = {}
    committee = dev_committee(NUM_VALIDATORS)
    ledger = L.Ledger(committee)
    genesis = ledger.latest_block
    times["genesis_s"] = time.time() - t0
    doc = {"log_degree": LOG_DEGREE, "num_validators": NUM_VALIDATORS,
           "keys": {k: hex(v) for k, v in KEYS.items()}, "tally_src": TALLY_SRC,
           "committee": committee.to_bytes().hex(), "genesis": genesis.to_bytes().hex(),
           "state_roots": [ledger.latest_state_root.hex()], "blocks": [], "openings": []}

    # block 1: solutions, a transfer_public with a fee, a same-block deploy
    # and execute of a finalize program
    t1 = time.time()
    prover = dev_account(0).address
    sols = find_solutions(genesis.epoch_hash, prover, genesis.proof_target,
                          L.MAX_SOLUTIONS_PER_BLOCK, args.workers)
    times["nonce_search_s"] = time.time() - t1
    t1 = time.time()
    sender = dev_account(1)
    recipient = dev_account(2).address
    transfer = L.create_transaction(
        f"execute credits.aleo/transfer_public {recipient} 5u64".encode(), fee=1,
        account=sender, key=KEYS["transfer"])
    deploy = L.create_transaction(TALLY_SRC.encode(), is_deploy=True, key=KEYS["deploy"])
    bump = L.create_transaction(b"execute tally.aleo/bump 7u64", fee=2, program=TALLY_SRC,
                                key=KEYS["bump"])
    times["block1_transactions_s"] = time.time() - t1
    block1 = block_from(ledger, 2, [*sols, transfer, deploy, bump])
    doc["solution_basic"] = []
    service = L.CoreLedgerService(ledger)
    bad_sol = dataclasses.replace(sols[0], eval_y=(sols[0].eval_y + 1) % R)
    for s in (*sols, bad_sol):
        doc["solution_basic"].append(verdict(lambda s=s: service.check_solution_basic(s)))

    def with_tms(block, i, obj):
        tms = list(block.transmissions)
        tms[i] = (types.Transmission.from_solution(obj) if isinstance(obj, types.Solution)
                  else types.Transmission.from_transaction(obj))
        return dataclasses.replace(block, transmissions=tuple(tms))

    outs = transfer.exec_outs.decode().split()
    outs[outs.index("5u64")] = "6u64"
    n = len(sols)
    tampered = {
        "solution_eval_y_plus_1": with_tms(block1, 0, bad_sol),
        "forged_exec_outs": with_tms(block1, n, dataclasses.replace(
            transfer, exec_outs=" ".join(outs).encode())),
        "garbage_exec_proof": with_tms(block1, n + 2, dataclasses.replace(
            bump, exec_proof=b"\x01" * 64)),
    }
    doc["tampered"] = {}
    for name, blk in tampered.items():
        doc["tampered"][name] = {"block": blk.to_bytes().hex(),
                                 **verdict(lambda b=blk: ledger.check_next_block(b))}
        assert not doc["tampered"][name]["accepted"], name

    t1 = time.time()
    ledger.check_next_block(block1)
    times["block1_check_s"] = time.time() - t1
    doc["openings"].append(openings_of(ledger, block1))
    ledger.advance_to_next_block(block1)
    doc["blocks"].append(block1.to_bytes().hex())
    doc["state_roots"].append(ledger.latest_state_root.hex())
    assert ledger.mappings[("tally.aleo", "tally")]["7u64"] == "1u64"

    # block 2: a transfer_public_to_private (execution SRS of degree 16,384)
    t1 = time.time()
    owner = dev_account(3)
    to_private = L.create_transaction(
        b"execute credits.aleo/transfer_public_to_private - 10u64", fee=3, account=owner,
        private_args=[V.parse_literal(owner.address), None], key=KEYS["to_private"])
    times["block2_transaction_s"] = time.time() - t1
    block2 = block_from(ledger, 4, [to_private])
    t1 = time.time()
    ledger.check_next_block(block2)
    times["block2_check_s"] = time.time() - t1
    doc["openings"].append(openings_of(ledger, block2))
    ledger.advance_to_next_block(block2)
    doc["blocks"].append(block2.to_bytes().hex())
    doc["state_roots"].append(ledger.latest_state_root.hex())
    assert ledger.record_ciphertexts.get(2), "block 2 seals no record"

    doc["srs_digest"] = {str(d): srs_digest(L.execution_srs(d)) for d in (512, 16384, 32768)}
    doc["jax_seconds"] = {k: round(v, 1) for k, v in times.items()}
    with open(args.out, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {args.out} in {time.time() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))


if __name__ == "__main__":
    main()
