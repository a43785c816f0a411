"""The port's block sync (snarkos_tpu_torch/node/block_sync.py), case for
case the JAX package's tests/test_block_sync.py: the common-ancestor map,
consistent-peer selection, expected-hash requests with redundancy
escalation, the request timeout, a malicious peer evicted mid-sync over a
30-block gap, and a response from a peer never asked. The ledgers are the
port's ``Ledger(device="cpu")`` over the committee of
tests/fixtures/torch_ledger_dev4.json, its genesis the fixture's (put in
``ledger._GENESIS_CACHE``, not proved anew); the reference tests' chains
grow with empty blocks, which the ``_NoCheck`` service takes unchecked.

Then the rule by which the port parts from the reference: what
``check_next_block`` raises on a block's content (``ValueError``,
``KeyError``, ``ledger.SRSTooSmall``) refuses the block as the reference
does, the height kept and the later responses too, and the sync goes on
with an honest peer (over the full check of a real ``Ledger``, which
refuses a forked chain's wrong epoch hash); a ``RuntimeError``, the port's
device fault (``ops/_build.py``: a CUDA error from a launch), propagates out
of ``insert_block_responses``. Last, the port's Client role over a real
``Ledger(device="cpu")`` fills it over localhost from the JAX package's
router serving the same chain."""

import time

import pytest

from snarkos_tpu_torch import convert
from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import block_sync as bs, ledger, messages as msg, roles
from snarkos_tpu_torch.node.block_sync import DUMMY_SELF, BlockSync, _pair
from snarkos_tpu_torch.node.cli import AccountView
from snarkos_tpu_torch.node.ledger import CoreLedgerService, Ledger
from snarkos_tpu_torch.node.types import Block
from snarkos_tpu_torch.ops import puzzle

import torch_node_support as sup
from torch_bft_support import standin_sign, standin_verify
from torch_net_support import account, announce, run, serve_blocks, until


@pytest.fixture(scope="module")
def committee():
    """The fixture's committee, its genesis the fixture's, and a puzzle over
    the known dev tau (``check_next_block`` reads its SRS on every block)."""
    doc = sup.fixture()
    mp = pytest.MonkeyPatch()
    comm = convert.committee(bytes.fromhex(doc["committee"]))
    mp.setitem(ledger._GENESIS_CACHE, comm.id, convert.block(bytes.fromhex(doc["genesis"])))
    mp.setattr(puzzle, "_PUZZLE", puzzle.Puzzle(doc["log_degree"], "cpu",
                                                 srs=sup.tau_srs(1 << doc["log_degree"])))
    yield comm
    mp.undo()


def _ledger(committee) -> Ledger:
    return Ledger(committee, device="cpu")


def _grow(led: Ledger, n: int, salt: int = 0, epoch_hash=None) -> None:
    for _ in range(n):
        prev = led.latest_block
        led.advance_to_next_block(Block(
            height=prev.height + 1, previous_hash=prev.hash,
            timestamp=prev.timestamp + 1 + salt, round=2 * (prev.height + 1),
            epoch_hash=epoch_hash or led._next_epoch_hash(prev.height + 1),
            proof_target=prev.proof_target, subdag=None, transmissions=()))


class _NoCheck(CoreLedgerService):
    def check_next_block(self, block):
        pass


def _engine(committee, sent, service=_NoCheck):
    svc = service(_ledger(committee))
    return svc, BlockSync(svc, lambda peer, req: sent.append((peer, req)))


async def _serve(sync, sent, chains, top):
    """Answer every request in ``sent`` from ``chains[peer]``, up to ``top``."""
    for peer, req in list(sent):
        blocks = [chains[peer].get_block(h)
                  for h in range(req.start_height, min(req.end_height, top + 1))]
        await sync.insert_block_responses(peer, blocks)


def test_common_ancestor_map(committee):
    """Locator updates keep the self- and pairwise common ancestors, stopping
    at the first bifurcation (block_sync.rs:391-439)."""
    fork = _ledger(committee)
    _grow(fork, 10, salt=7)  # diverges right after genesis
    sent = []
    svc, sync = _engine(committee, sent)
    _grow(svc.ledger, 4)
    # peerA follows our chain (the same deterministic blocks)
    ours = _ledger(committee)
    _grow(ours, 10)
    assert sync.update_peer_locators("peerA", ours.latest_block_locators())
    # the self ancestor is our height (4): every canon hash matches peerA's chain
    assert sync.common_ancestors[_pair(DUMMY_SELF, "peerA")] == 4
    # peerB is on a fork from genesis: ancestor 0
    assert sync.update_peer_locators("peerB", fork.latest_block_locators())
    assert sync.common_ancestors[_pair(DUMMY_SELF, "peerB")] == 0
    # the A-B ancestor exists and is the genesis only
    assert sync.common_ancestors[_pair("peerA", "peerB")] == 0


def test_find_sync_peers_excludes_forked_cohort(committee):
    """Peer selection keeps only the peers whose pairwise ancestor with the
    tallest peer is above canon (block_sync.rs:718-760)."""
    sent = []
    svc, sync = _engine(committee, sent)
    main, fork, short = _ledger(committee), _ledger(committee), _ledger(committee)
    _grow(main, 20)
    _grow(fork, 18, salt=3)
    _grow(short, 15)
    assert sync.update_peer_locators("tall", main.latest_block_locators())
    assert sync.update_peer_locators("mid", short.latest_block_locators())
    assert sync.update_peer_locators("forked", fork.latest_block_locators())
    found = sync.find_sync_peers()
    assert found is not None
    peers, min_ca = found
    assert "tall" in peers and "mid" in peers
    assert "forked" not in peers
    assert min_ca == 15  # the cohort's minimum common ancestor


def test_request_timeout_and_completeness(committee):
    """The 600 s timeout removes only INCOMPLETE requests; obsolete heights are
    dropped (block_sync.rs:672-716)."""
    sent = []
    svc, sync = _engine(committee, sent)
    sync.requests[5] = (None, None, {"p1"})  # incomplete
    sync.requests[6] = (None, None, set())  # complete
    sync.request_times[5] = time.time() - bs.BLOCK_REQUEST_TIMEOUT_S - 1
    sync.request_times[6] = time.time() - bs.BLOCK_REQUEST_TIMEOUT_S - 1
    sync._gc_timed_out_requests()
    assert 5 not in sync.requests
    assert 6 in sync.requests
    # fresh incomplete requests survive
    sync.requests[7] = (None, None, {"p1"})
    sync.request_times[7] = time.time()
    sync._gc_timed_out_requests()
    assert 7 in sync.requests


def test_redundancy_escalation_on_dishonest_locators(committee):
    """Disagreeing locator hashes escalate to EXTRA_REDUNDANCY_FACTOR sync ips;
    an honest confirmed hash needs one (construct_request,
    block_sync.rs:869-928)."""
    sent = []
    svc, sync = _engine(committee, sent)
    main, fork = _ledger(committee), _ledger(committee)
    _grow(main, 8)
    _grow(fork, 8, salt=9)
    honest, lying = main.latest_block_locators(), fork.latest_block_locators()
    # an honest cohort: the expected hash confirmed, one sync ip a request
    reqs = sync._construct_requests({"a": honest}, min_ca=8)
    assert reqs and all(n == 1 and h is not None for _, (h, _, n) in reqs)
    # a disagreeing cohort: no expected hash, escalation (needs >= 3 peers)
    reqs = sync._construct_requests({"a": honest, "b": lying, "c": honest}, min_ca=8)
    assert reqs and all(n == bs.EXTRA_REDUNDANCY_FACTOR and h is None
                        for _, (h, _, n) in reqs)


def test_thirty_block_gap_sync_with_malicious_peer(committee):
    """Sync a 30-block gap; a malicious peer serving a conflicting block loses
    its requests mid-sync and the honest peer completes the sync."""
    src, evil = _ledger(committee), _ledger(committee)
    _grow(src, 30)
    _grow(evil, 30, salt=13)
    chains = {"honest": src, "evil": evil}

    async def go():
        sent = []
        svc, sync = _engine(committee, sent)
        loc = src.latest_block_locators()
        assert sync.update_peer_locators("honest", loc)
        assert sync.update_peer_locators("evil", loc)  # evil ADVERTISES the honest chain
        assert not sync.is_block_synced()
        await sync.try_block_sync()
        assert sent, "no requests issued"
        # evil answers with its forked blocks, honest with the real ones
        await _serve(sync, sent, chains, 30)
        # the conflicting block was rejected against the expected locator hash
        # and evil's outstanding requests were revoked
        assert all("evil" not in ips for _, _, ips in sync.requests.values())
        # keep syncing: each lie revokes evil's requests and the heights are
        # assigned again; honest serves correctly
        for _ in range(60):
            if svc.latest_height() == 30:
                break
            sent.clear()
            await sync.try_block_sync()
            await _serve(sync, sent, chains, 30)
        assert svc.latest_height() == 30
        assert sync.is_block_synced()
        assert [svc.get_block(h).hash for h in range(31)] == [src.get_block(h).hash
                                                              for h in range(31)]

    run(go())


def test_response_from_unrequested_peer_rejected(committee):
    """A block response from a peer the pool never asked is rejected
    (check_block_response, block_sync.rs:570-607)."""
    src = _ledger(committee)
    _grow(src, 5)

    async def go():
        sent = []
        svc, sync = _engine(committee, sent)
        assert sync.update_peer_locators("peerA", src.latest_block_locators())
        await sync.try_block_sync()
        assert sent
        await sync.insert_block_responses("stranger", [src.get_block(1)])
        assert svc.latest_height() == 0  # nothing advanced

    run(go())


# -- a refusal against a device fault ---------------------------------------------


class _Raising(CoreLedgerService):
    """Raises ``exc`` from the block check."""

    exc: Exception = None

    def check_next_block(self, block):
        raise self.exc


@pytest.mark.parametrize("exc, propagates", [
    (ValueError("invalid solution in block"), False),
    (KeyError("no block at height 0"), False),
    (ledger.SRSTooSmall("SRS artifact too small: execution circuit needs degree 32768"), False),
    (RuntimeError("fr_poseidon_permute: CUDA error 700"), True),
], ids=["ValueError", "KeyError", "SRSTooSmall", "RuntimeError"])
def test_check_errors_refuse_or_propagate(committee, exc, propagates):
    """A block the check refuses leaves the height and the later responses;
    a RuntimeError (the port's device fault, as ``_build.launch`` raises it)
    propagates out of ``insert_block_responses``, the block unapplied."""
    src = _ledger(committee)
    _grow(src, 3)
    service = type("Svc", (_Raising,), {"exc": exc})

    async def go():
        sent = []
        svc, sync = _engine(committee, sent, service)
        assert sync.update_peer_locators("peer", src.latest_block_locators())
        await sync.try_block_sync()
        (peer, req), = sent
        blocks = [src.get_block(h) for h in range(req.start_height, req.end_height)]
        if propagates:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                await sync.insert_block_responses(peer, blocks)
        else:
            await sync.insert_block_responses(peer, blocks)
        assert svc.latest_height() == 0
        assert sorted(sync.responses) == [2, 3]  # block 1's was taken for the check

    run(go())


def test_refused_block_keeps_height_and_sync_goes_on(committee):
    """Over the full check of a real ``Ledger``: a peer that serves a fork whose
    blocks carry a wrong epoch hash (and announces that fork) has block 1
    refused with the ledger's ValueError; the height stays 0 and nothing
    propagates. Then an honest peer announces a taller chain and the sync
    goes on with it to the top, refusing the forked responses left in the
    pool on the way."""
    src, evil = _ledger(committee), _ledger(committee)
    _grow(src, 7)
    _grow(evil, 5, epoch_hash=b"\x5a" * 32)
    chains = {"honest": src, "evil": evil}
    refusals = []

    class Service(CoreLedgerService):
        def check_next_block(self, block):
            try:
                super().check_next_block(block)
            except ValueError as exc:
                refusals.append((block.height, str(exc)))
                raise

    async def go():
        sent = []
        svc, sync = _engine(committee, sent, Service)
        assert sync.update_peer_locators("evil", evil.latest_block_locators())
        await sync.try_block_sync()
        await _serve(sync, sent, chains, 5)
        assert svc.latest_height() == 0
        assert refusals == [(1, "wrong epoch hash")]
        assert sorted(sync.responses) == [2, 3, 4, 5]
        assert sync.update_peer_locators("honest", src.latest_block_locators())
        for _ in range(20):
            if svc.latest_height() == 7:
                break
            sent.clear()
            await sync.try_block_sync()
            await _serve(sync, sent, chains, 7)
        assert svc.latest_height() == 7
        assert [svc.get_block(h).hash for h in range(8)] == [src.get_block(h).hash
                                                             for h in range(8)]
        assert refusals[0] == (1, "wrong epoch hash")
        assert all(err == "previous hash mismatch" for _, err in refusals[1:])

    run(go())


# -- from the JAX package's router ----------------------------------------------------


def test_fills_from_jax_router(committee, monkeypatch):
    """The JAX package's router serves a 12-block chain (the port ledger's
    bytes, decoded by the JAX types) and announces its locators with a Ping;
    the port's Client role (``roles.Client`` on the CPU, its sync loop every
    10 ms) connects to it and syncs every block through the full check of
    its ``Ledger``, byte for byte. The handshakes sign with the keyed-hash
    stand-in on both sides."""
    from snarkos_tpu.crypto.ref import edwards as jedwards
    from snarkos_tpu.node import messages as jmsg, router as jrouter, types as jtypes

    for mod in (edwards, jedwards):
        monkeypatch.setattr(mod, "sign_bytes", standin_sign)
        monkeypatch.setattr(mod, "verify_bytes", standin_verify)
    monkeypatch.setattr(roles, "SYNC_INTERVAL_S", 0.01)
    src = _ledger(committee)
    _grow(src, 12)
    jblocks = [jtypes.Block.from_bytes(b.to_bytes()) for b in src.blocks]
    loc = src.latest_block_locators()
    jloc = jmsg.BlockLocators(recents=loc.recents, checkpoints=loc.checkpoints)
    responses = []

    async def go():
        server = jrouter.Router(account(1), jmsg.NodeType.VALIDATOR, jblocks[0].hash)
        serve_blocks(server, lambda h: jblocks[h], lambda: len(jblocks) - 1, jmsg)
        client = roles.Client(AccountView(account(0)), committee, device="cpu")
        on_response = client.router.handlers[msg.BlockResponse]

        async def counted(addr, peer, resp):
            responses.append(len(resp.blocks))
            await on_response(addr, peer, resp)

        client.router.handlers[msg.BlockResponse] = counted
        addr = await server.run()
        await client.start()
        try:
            assert await client.router.connect(addr)
            assert await until(lambda: server.number_of_connected_peers() == 1)
            (back,) = server.peers
            announce(server, back, jloc, jmsg)
            assert await until(lambda: client.ledger.latest_height == 12 or client.halted.is_set(),
                               10.0), f"the sync stopped at height {client.ledger.latest_height}"
        finally:
            await client.shut_down()
            await server.shut_down()
        return client

    client = run(go(), 15.0)
    assert client.fault is None
    assert [b.to_bytes() for b in client.ledger.blocks] == [b.to_bytes() for b in jblocks]
    assert len(responses) >= 3  # 12 blocks in requests of at most 5
    assert client.block_sync.is_block_synced()


def test_tampered_block_bytes_refused_by_hash(committee):
    """A peer that announces the honest chain and serves block 1 with one byte
    changed has it refused against the announced hash before any check: its
    requests are revoked and the height stays (block_sync.rs:570-607)."""
    src = _ledger(committee)
    _grow(src, 2)
    raw = bytearray(src.get_block(1).to_bytes())
    raw[9] ^= 1  # a byte of the previous hash
    bad = Block.from_bytes(bytes(raw))

    async def go():
        sent = []
        svc, sync = _engine(committee, sent)
        assert sync.update_peer_locators("peer", src.latest_block_locators())
        await sync.try_block_sync()
        (peer, _), = sent
        await sync.insert_block_responses(peer, [bad, src.get_block(2)])
        assert svc.latest_height() == 0
        assert all(peer not in ips for _, _, ips in sync.requests.values())
        assert sync.responses == {}

    run(go())


def test_block_request_and_response_frames_equal_jax_bytes(committee):
    """The sync's two messages, a BlockRequest and the BlockResponse of three
    blocks, serialize to the JAX package's bytes, and the port decodes the
    JAX frame back to the same blocks."""
    from snarkos_tpu.node import messages as jmsg, types as jtypes

    src = _ledger(committee)
    _grow(src, 3)
    jblocks = tuple(jtypes.Block.from_bytes(b.to_bytes()) for b in src.blocks[1:])
    req, jreq = msg.BlockRequest(1, 4), jmsg.BlockRequest(1, 4)
    assert msg.serialize(req) == jmsg.serialize(jreq)
    frame = jmsg.serialize(jmsg.BlockResponse(jreq, jblocks))
    assert msg.serialize(msg.BlockResponse(req, tuple(src.blocks[1:]))) == frame
    resp = msg.deserialize(frame)
    resp.ensure_well_formed()
    assert [b.to_bytes() for b in resp.blocks] == [b.to_bytes() for b in src.blocks[1:]]


def test_srs_too_small_is_the_ledgers_runtime_error(committee, monkeypatch):
    """The one RuntimeError the block check raises on a block's content, a
    circuit above the ceremony artifact's degree, is ``ledger.SRSTooSmall``:
    still a RuntimeError to every other caller, with the JAX ledger's
    message, and a refusal to the sync."""
    from types import SimpleNamespace

    artifact = SimpleNamespace(is_dev=False, srs_ref=SimpleNamespace(powers_g1=[None] * 4097))
    monkeypatch.setattr(ledger, "global_puzzle", lambda device=None: SimpleNamespace(srs=artifact))
    with pytest.raises(ledger.SRSTooSmall) as err:
        ledger._trimmed_srs(16384, "cpu", "execution circuit")
    assert isinstance(err.value, RuntimeError)
    assert str(err.value) == "SRS artifact too small: execution circuit needs degree 16384"
