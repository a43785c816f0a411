"""The port's primary and Consensus (snarkos_tpu_torch/node/bft/primary.py,
consensus.py) on the host: a batch proposal signed by one package is
endorsed by the other and the endorsement verifies there (real Schnorr
signatures); proposals from a non-member, for another committee or with a
stale timestamp are refused by both with the same error; four port
validators over the in-process transport (tests/torch_bft_support.py) on
``MockLedgerService(device="cpu")`` admit transmissions, then commit blocks
with equal prefixes, each transmission once; a fifth node syncs their
blocks; and the lazy builds that the validators' threads share (the puzzle,
an epoch program, a Varuna index, the execution SRSs, the genesis, a
kernel's launch counter) happen once when many threads ask together.

The network test shortens the primary's timers and puts a keyed hash in
place of the Schnorr signatures (four pure-Python verifies a certificate,
the slowest part of the flow on the CPU): it checks the flow of the
consensus, not the signatures; the card runs the network with both as they
are (chip_smoke.py)."""

import asyncio
import hashlib
import threading
import time

import pytest
import torch

from snarkos_tpu.node import cli as jcli, events as jevents, types as jtypes
from snarkos_tpu.node.bft import primary as jprimary, storage as jstorage
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import consensus, events, ledger, types
from snarkos_tpu_torch.node.bft import bft, primary, storage
from snarkos_tpu_torch.utils import native

import torch_bft_support as sup
import torch_node_support as nsup


class Capture:
    """A transport that keeps what is sent."""

    def __init__(self):
        self.sent = []

    def send(self, peer, event):
        self.sent.append((peer, event))
        return True

    def broadcast(self, event):
        self.sent.append((None, event))
        return 0


def _primary(pkg, account):
    """A primary of the JAX package (pkg "jax") or of the port, over a stub
    ledger of the dev committee."""
    if pkg == "jax":
        led = sup.StubLedger(jcli.dev_committee(4))
        st = jstorage.NarwhalStorage(led, jstorage.BFTMemoryService())
        return jprimary.Primary(account, led, st, Capture())
    led = sup.StubLedger(sup.dev_committee(4))
    st = storage.NarwhalStorage(led, storage.BFTMemoryService())
    return primary.Primary(sup.AccountView(account), led, st, Capture())


@pytest.mark.parametrize("proposer", ["jax", "port"])
def test_proposal_endorsed_across_packages(proposer):
    """One package signs a round-1 proposal; the other's primary checks and
    endorses it (``process_batch_propose``); the proposer's
    ``Proposal.add_signature`` verifies the endorsement."""
    jmods = (jtypes, jevents, jprimary, jcli.dev_committee(4))
    pmods = (types, events, primary, sup.dev_committee(4))
    (ptypes, pevents, pprim, pcomm), (otypes, oevents, oprim, _) = \
        (jmods, pmods) if proposer == "jax" else (pmods, jmods)
    prop_acct = (jcli if proposer == "jax" else sup).dev_account(1)
    endorser_acct = (sup if proposer == "jax" else jcli).dev_account(0)
    header = ptypes.BatchHeader.sign_new(prop_acct, 1, int(time.time()), pcomm.id, [], [])
    raw = pevents.serialize(pevents.BatchPropose(1, header.to_bytes()))
    endorser = _primary("port" if proposer == "jax" else "jax", endorser_acct)
    asyncio.run(endorser.process_batch_propose(prop_acct.address, oevents.deserialize(raw)))
    (peer, reply), = endorser.transport.sent
    assert peer == prop_acct.address and type(reply).__name__ == "BatchSignature"
    answer = pevents.deserialize(oevents.serialize(reply))
    assert answer.batch_id == header.batch_id
    prop = pprim.Proposal(batch_header=header, transmissions={})
    prop.add_signature(endorser_acct.address, answer.signature, pcomm)
    assert list(prop.signatures) == [endorser_acct.address]
    with pytest.raises(ValueError, match="invalid batch signature"):
        prop.add_signature(endorser_acct.address, (answer.signature[0], answer.signature[1] ^ 1),
                           pcomm)


REFUSED = {
    "non-member": "proposal from non-committee member",
    "committee id": "proposal committee id mismatch",
    "stale timestamp": "proposal timestamp out of range",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_proposal_refused_by_both(case):
    comm = jcli.dev_committee(4)
    author = sorted(comm.addresses)[1]
    hdr = jtypes.BatchHeader(
        author="aleo1" + "11" * 32 if case == "non-member" else author, round=1,
        timestamp=int(time.time()) - (1000 if case == "stale timestamp" else 0),
        committee_id=bytes(32) if case == "committee id" else comm.id,
        transmission_ids=(), previous_certificate_ids=(), signature=(1, 2))
    raw = jevents.serialize(jevents.BatchPropose(1, hdr.to_bytes()))
    acct = jcli.dev_account(0)
    for pkg, decode in (("jax", jevents.deserialize), ("port", convert.event)):
        prim = _primary(pkg, acct)
        with pytest.raises(ValueError, match=REFUSED[case]):
            asyncio.run(prim.process_batch_propose(author, decode(raw)))
        assert prim.transport.sent == [] and prim.signed_proposals == {}


@pytest.fixture
def quick_network(monkeypatch):
    """The dev committee's genesis from the fixture (no proof on the CPU),
    short timers and the keyed-hash signatures."""
    comm = sup.dev_committee(4)
    monkeypatch.setitem(ledger._GENESIS_CACHE, comm.id,
                        convert.block(bytes.fromhex(nsup.fixture()["genesis"])))
    monkeypatch.setattr(primary, "MIN_BATCH_DELAY_S", 0.02)
    monkeypatch.setattr(primary, "MAX_BATCH_DELAY_S", 0.1)
    monkeypatch.setattr(primary, "MAX_LEADER_CERTIFICATE_DELAY_S", 0.5)
    monkeypatch.setattr(bft, "MAX_LEADER_CERTIFICATE_DELAY_S", 0.5)
    monkeypatch.setattr(edwards, "sign_bytes", sup.standin_sign)
    monkeypatch.setattr(edwards, "verify_bytes", sup.standin_verify)
    return comm


def _solution(i: int) -> types.Solution:
    return types.Solution(epoch_hash=hashlib.sha256(b"epoch").digest(),
                          address=sup.dev_account(0).address, nonce=i, commitment=bytes(97),
                          eval_y=i, witness=bytes(97))


async def _run_network(comm, n_solutions: int, min_blocks: int):
    net = sup.TestNetwork([sup.dev_account(i) for i in range(4)],
                          lambda c: ledger.MockLedgerService(c, device="cpu"), comm)
    sols = [_solution(i) for i in range(n_solutions)]
    for node in net.nodes.values():
        for sol in sols:
            await node.add_unconfirmed_solution(sol)
        with pytest.raises(ValueError, match="already seen"):
            await node.add_unconfirmed_solution(sols[0])
    await net.start_intake()
    want = {s.id for s in sols}
    while any(set(n.primary.worker.ready) != want for n in net.nodes.values()):
        await asyncio.sleep(0.01)
    net.connect_all()
    await net.start()
    try:
        while min(len(b) for b in net.blocks.values()) < min_blocks:
            await asyncio.sleep(0.01)
    finally:
        await net.stop()
    return net, want


def test_four_validators_commit_equal_blocks(quick_network):
    comm = quick_network
    native.load_engines()  # a fresh checkout's first build is no part of the limit
    net, want = asyncio.run(asyncio.wait_for(_run_network(comm, 4, 2), 30))
    chains = [[b.hash for b in svc._blocks] for svc in net.services.values()]
    common = min(len(c) for c in chains)
    assert common >= 3  # the genesis and two blocks
    assert all(c[:common] == chains[0][:common] for c in chains)
    for svc in net.services.values():
        committed = [t.id for b in svc._blocks[1:] for t in b.transmissions]
        assert len(committed) == len(set(committed))  # none twice
        assert set(committed) <= want
        for b in svc._blocks[1:]:
            assert b.round % 2 == 0 and b.round == b.subdag.anchor_round
            assert b.subdag.leader_certificate.author == comm.get_leader(b.round)
    # intake ended before the first proposal: block 1 holds them all
    assert all({t.id for t in svc._blocks[1].transmissions} == want
               for svc in net.services.values())

    # a fifth node catches up through sync_with_block, block by block
    async def sync():
        node = consensus.Consensus(sup.AccountView(sup.dev_account(0)),
                                   ledger.MockLedgerService(comm, device="cpu"), Capture())
        src = next(iter(net.services.values()))._blocks[1:common]
        for blk in src:
            node.sync_with_block(blk)
        return node, src

    node, src = asyncio.run(sync())
    assert [b.hash for b in node.ledger._blocks] == chains[0][:common]
    assert node.storage.current_round() == src[-1].round + 1
    assert node.dag.last_committed_round == src[-1].round
    assert all(node.dag.is_recently_committed(c.round, c.id)
               for b in src for c in b.subdag.all_certificates())


def _together(fn, n=8):
    """Run ``fn`` in n threads released at once; their results."""
    start, out = threading.Barrier(n), [None] * n

    def run(i):
        start.wait()
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_lazy_builds_happen_once_across_threads(monkeypatch):
    from snarkos_tpu_torch.crypto.ref import varuna
    from snarkos_tpu_torch.ops import _build, puzzle

    built = []

    def slow(tag, value):
        def make(*args, **kwargs):
            built.append(tag)
            time.sleep(0.05)
            return value(*args) if callable(value) else value
        return make

    class FakePuzzle:
        def __init__(self, log_degree, device):
            built.append("puzzle")
            time.sleep(0.05)
            self.log_degree, self.device = log_degree, torch.device(device)

    monkeypatch.setattr(puzzle, "_PUZZLE", None)
    with monkeypatch.context() as m:
        m.setattr(puzzle, "Puzzle", FakePuzzle)
        assert len({id(p) for p in _together(lambda: puzzle.global_puzzle(3, "cpu"))}) == 1

    # an epoch program of one real instance (its SRS a stand-in)
    monkeypatch.setattr(puzzle, "EpochProgram", slow("program", lambda h, k, d: (h, k)))
    inst = puzzle.Puzzle(2, "cpu", srs=nsup.tau_srs(4))
    assert len(set(_together(lambda: inst.epoch_program(b"e")))) == 1

    monkeypatch.setattr(varuna, "_INDEX_CACHE", {})
    monkeypatch.setattr(varuna, "index_circuit", slow("index", object()))
    srs = nsup.tau_srs(4).srs_ref

    class CS:
        @staticmethod
        def digest():
            return b"cs"

    assert len({id(i) for i in _together(lambda: varuna.get_index(srs, CS))}) == 1

    monkeypatch.setattr(ledger, "_EXEC_SRS_CACHE", {})
    monkeypatch.setattr(ledger, "_trimmed_srs", slow("srs", object()))
    assert len({id(s) for s in _together(lambda: ledger.execution_srs(99, "cpu"))}) == 1

    comm = types.Committee.new(1, {"aleo1" + "22" * 32: 100})
    monkeypatch.setattr(ledger, "create_transaction", slow("genesis", types.Transaction(
        payload=b"", fee=0, auth_tag=0, proof=b"", is_deploy=True)))
    monkeypatch.setitem(ledger._GENESIS_CACHE, comm.id, None)
    del ledger._GENESIS_CACHE[comm.id]
    assert len({id(g) for g in _together(lambda: ledger.make_genesis(comm, "cpu"))}) == 1
    assert sorted(built) == ["genesis", "index", "program", "puzzle", "srs"]

    def counted():
        pass

    counted.launches = 0
    _together(lambda: [_build.count(counted) for _ in range(20000)])
    assert counted.launches == 8 * 20000
