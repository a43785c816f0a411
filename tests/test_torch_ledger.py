"""The port's ledger (snarkos_tpu_torch/node/ledger.py) on device="cpu"
against the golden chain the JAX ledger made (tests/fixtures/
torch_ledger_dev4.json; scripts/make_torch_ledger_fixture.py): block 1 (4
solutions at puzzle log degree 12, a transfer_public with a fee, a deploy
and an execute of a finalize program in one block) is accepted with the
JAX openings and state root, every tampered variant raises the JAX ledger's
ValueError, and ``check_solution_basic`` gives the JAX verdicts. Exact:
bytes, field values and affine points.

Tier 1 keeps the CPU cost to seconds with stand-ins for what the kernel
tests and the card hold elsewhere: the dev SRS by its known tau
(``torch_node_support.tau_srs``: lazy host powers, commitments p(tau) G in
place of ``ledger.device_commit``), the sponge's leaves by the JAX package's
host Poseidon (the epoch program, the evaluation and every other step of
the binding run the port's plain versions; each solution's binding is
checked once a module), and the batch's two MSMs by the host Pippenger.
``-m slow`` checks block 2 (an execution SRS of degree 16,384) with the
port's plain MSMs in the batch, and builds the genesis block anew."""

import dataclasses

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto.ref import poseidon as jposeidon
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.node import ledger, types
from snarkos_tpu_torch.ops import kzg as kzg_ops, msm as msm_mod, puzzle
from snarkos_tpu_torch.ops.fieldspec import FR

import torch_node_support as sup

LOG_DEGREE = 12
REAL_MSM = msm_mod.msm


def _leaves_host(self, seed_fields):
    """``Puzzle._leaves_device`` by the JAX package's host sponge."""
    k = self.k
    rows = [jposeidon.hash_many([s, i], rate=2, domain=puzzle.COEFF_DOMAIN)[0]
            for s in seed_fields for i in range(k)]
    enc = FR.encode_fast(rows, mont=True).reshape(FR.nlimbs, len(seed_fields), k)
    return torch.from_numpy(np.ascontiguousarray(enc)).to(self.device)


def _once(check_binding):
    """``Puzzle.check_binding`` run once for each argument tuple (the block
    checks of one module meet the same solutions again)."""
    cache = {}

    def once(self, *args):
        if args not in cache:
            cache[args] = check_binding(self, *args)
        return cache[args]

    return once


@pytest.fixture(scope="module")
def env():
    """The stand-ins above, the genesis seeded from the fixture, and the
    openings each batch was given."""
    doc = sup.fixture()
    mp = pytest.MonkeyPatch()
    genesis = convert.block(bytes.fromhex(doc["genesis"]))
    comm = convert.committee(bytes.fromhex(doc["committee"]))
    mp.setitem(ledger._GENESIS_CACHE, comm.id, genesis)
    pz = puzzle.Puzzle(LOG_DEGREE, "cpu", srs=sup.tau_srs(1 << LOG_DEGREE))
    mp.setattr(puzzle, "_PUZZLE", pz)
    mp.setattr(puzzle.Puzzle, "_leaves_device", _leaves_host)
    mp.setattr(puzzle.Puzzle, "check_binding", _once(puzzle.Puzzle.check_binding))
    mp.setattr(ledger, "device_commit", sup.tau_commit)
    mp.setattr(msm_mod, "msm", sup.host_sum_msm)
    for need in (16384, 32768):
        mp.setitem(ledger._EXEC_SRS_CACHE, (need, torch.device("cpu")), sup.tau_srs(need))
    batches = []
    real_batch = kzg_ops.batch_verify

    def spy(srs, openings, gamma=None, device=None):
        batches.append(list(openings))
        return real_batch(srs, openings, gamma, device)

    mp.setattr(kzg_ops, "batch_verify", spy)
    yield doc, comm, batches
    mp.undo()


def _block(doc, i):
    return convert.block(bytes.fromhex(doc["blocks"][i]))


@pytest.fixture(scope="module")
def chain(env):
    doc, _comm, _ = env
    return convert.ledger(bytes.fromhex(doc["committee"]), [bytes.fromhex(doc["genesis"])],
                          device="cpu")


def test_genesis_state(env, chain):
    doc = env[0]
    assert chain.device == torch.device("cpu")
    assert chain.latest_block.to_bytes() == bytes.fromhex(doc["genesis"])
    assert chain.latest_state_root.hex() == doc["state_roots"][0]
    assert "credits.aleo" in chain.parsed_programs
    assert ledger.make_genesis(env[1], "cpu") is ledger._GENESIS_CACHE[env[1].id]


@pytest.mark.parametrize("name", ["solution_eval_y_plus_1", "forged_exec_outs",
                                  "garbage_exec_proof"])
def test_tampered_block_rejected(env, chain, name):
    case = env[0]["tampered"][name]
    assert not case["accepted"]
    blk = convert.block(bytes.fromhex(case["block"]))
    with pytest.raises(ValueError) as err:
        chain.check_next_block(blk)
    assert str(err.value) == case["error"]


def test_block1_accepted_with_jax_openings_and_root(env, chain):
    doc, _comm, batches = env
    blk = _block(doc, 0)
    del batches[:]
    chain.check_next_block(blk)
    assert len(batches) == 1
    assert sup.openings_json(batches[0]) == doc["openings"][0]
    assert len(batches[0]) == 4 + 4 + 2 + 4  # solutions, transfer, deploy, execute
    chain.advance_to_next_block(blk)
    assert chain.latest_state_root.hex() == doc["state_roots"][1]
    assert chain.get_mapping_value("tally.aleo", "tally", "7u64") == "1u64"
    with pytest.raises(ValueError, match="height"):
        chain.check_next_block(blk)


@pytest.mark.parametrize("which", [0, "tampered"])
def test_check_solution_basic_agrees(env, which):
    """The JAX verdict of CoreLedgerService.check_solution_basic, on a
    ledger at the solutions' epoch."""
    doc = env[0]
    ledger_at_genesis = convert.ledger(bytes.fromhex(doc["committee"]),
                                       [bytes.fromhex(doc["genesis"])], device="cpu")
    service = ledger.CoreLedgerService(ledger_at_genesis)
    sols = [t.deserialize() for t in _block(doc, 0).transmissions
            if t.kind == types.TX_SOLUTION]
    if which == "tampered":
        sol, want = dataclasses.replace(sols[0], eval_y=(sols[0].eval_y + 1) % ledger.R), \
            doc["solution_basic"][-1]
    else:
        sol, want = sols[which], doc["solution_basic"][which]
    if want["accepted"]:
        service.check_solution_basic(sol)
    else:
        with pytest.raises(ValueError) as err:
            service.check_solution_basic(sol)
        assert str(err.value) == want["error"]


def test_replay_gives_jax_roots(env):
    """convert.ledger replays the whole chain (no checks): the JAX state root
    at every height, and block 2's sealed record."""
    doc = env[0]
    raws = [bytes.fromhex(doc["genesis"])] + [bytes.fromhex(b) for b in doc["blocks"]]
    replayed = convert.ledger(bytes.fromhex(doc["committee"]), raws, device="cpu")
    assert [replayed.state_root_at(h).hex() for h in range(len(raws))] == doc["state_roots"]
    assert replayed.record_ciphertexts.get(2)
    locs = replayed.latest_block_locators()
    assert locs.latest_height == 2 and locs.is_well_formed()


@pytest.mark.slow
def test_block2_accepted(env, monkeypatch):
    """Block 2 (transfer_public_to_private, execution SRS of degree 16,384)
    on a ledger after block 1, with the plain MSM engine in the batch."""
    doc, _comm, batches = env
    monkeypatch.setattr(msm_mod, "msm", REAL_MSM)
    raws = [bytes.fromhex(doc["genesis"]), bytes.fromhex(doc["blocks"][0])]
    at1 = convert.ledger(bytes.fromhex(doc["committee"]), raws, device="cpu")
    del batches[:]
    at1.check_next_block(_block(doc, 1))
    assert sup.openings_json(batches[0]) == doc["openings"][1]
    at1.advance_to_next_block(_block(doc, 1))
    assert at1.latest_state_root.hex() == doc["state_roots"][2]


def test_create_transaction_matches_jax_bytes(env):
    """The transfer_public of block 1 created by the port on device="cpu"
    from its signed payload and key: the JAX transaction byte for byte
    (the authorization proof at degree 4096, the execution proof and its
    claimed outputs)."""
    doc = env[0]
    tx = next(t.deserialize() for t in _block(doc, 0).transmissions
              if t.kind == types.TX_TRANSACTION and b"transfer_public" in t.deserialize().payload)
    new = ledger.create_transaction(tx.payload, fee=tx.fee, key=int(doc["keys"]["transfer"], 16),
                                    device="cpu")
    assert new.to_bytes() == tx.to_bytes()


@pytest.mark.slow
def test_make_genesis_matches_jax_bytes(env, monkeypatch):
    """make_genesis on device="cpu" (the credits.aleo deploy proved with the
    genesis key, every provable function's verifying key indexed; ~15 s of
    host polynomial arithmetic): the JAX genesis block byte for byte."""
    doc, comm, _ = env
    monkeypatch.delitem(ledger._GENESIS_CACHE, comm.id)
    assert ledger.make_genesis(comm, "cpu").to_bytes() == bytes.fromhex(doc["genesis"])
