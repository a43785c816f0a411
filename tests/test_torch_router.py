"""The port's router (snarkos_tpu_torch/node/router.py), case for case the
JAX package's tests/test_router_policies.py: the SYNC_LENIENCY gossip gate,
the heartbeat's prover cap and churn, and the worker's redundant-fetch
budget (bft/primary.py, through a mock transport). The workers stand on
``torch_bft_support.StubLedger`` where the reference tests build a
``MockLedgerService``, whose genesis is a proof on the CPU.

Then the port's router against the JAX package's over localhost, with real
Schnorr signatures: the handshake completes with either side dialing, and
with the handshake's randomness fixed (``secrets.randbits``, the Schnorr
nonce's ``secrets.randbelow``) and the listening port each side announces
fixed, every frame the port sends in a role (the challenge request and
response, a Ping with locators, the Pong) is byte for byte the frame the
JAX router sends in that role."""

import secrets
import time

import pytest

from snarkos_tpu_torch.node import codec, events as ev, messages as msg
from snarkos_tpu_torch.node.bft.primary import Worker
from snarkos_tpu_torch.node.bft.storage import BFTMemoryService, NarwhalStorage
from snarkos_tpu_torch.node.router import SYNC_LENIENCY, Peer, Router
from snarkos_tpu_torch.node.types import TransmissionID

from torch_bft_support import StubLedger
from torch_net_support import account, committee, handshake_nonce, run, until

GENESIS = b"\x11" * 32


def _router(**kw):
    return Router(account(0), msg.NodeType.CLIENT, b"\x00" * 32, **kw)


class _Locators:
    def __init__(self, height):
        self.latest_height = height

    def is_well_formed(self):
        return True

    def is_consistent_with(self, other):
        return True


def _peer_with_height(height, node_type=msg.NodeType.CLIENT):
    p = Peer(("127.0.0.1", 4130), node_type, msg.VERSION, "aleo1test")
    p.block_locators = _Locators(height)
    return p


def test_sync_leniency_gate():
    r = _router()
    r.latest_height_fn = lambda: 100
    # no peers -> synced
    assert r.is_within_sync_leniency()
    r.peers[("1.2.3.4", 1)] = _peer_with_height(100 + SYNC_LENIENCY)
    assert r.is_within_sync_leniency()
    r.peers[("1.2.3.5", 2)] = _peer_with_height(100 + SYNC_LENIENCY + 1)
    assert not r.is_within_sync_leniency()
    assert r.num_blocks_behind() == SYNC_LENIENCY + 1


def test_unconfirmed_gossip_dropped_while_syncing():
    async def go():
        r = _router()
        r.latest_height_fn = lambda: 0
        addr = ("1.2.3.4", 1)
        r.peers[addr] = _peer_with_height(1000)
        seen = []

        async def handler(a, p, mm):
            seen.append(mm)

        r.handlers[msg.UnconfirmedTransaction] = handler
        m = msg.UnconfirmedTransaction(TransmissionID(1, b"\x01" * 32), b"payload")
        await r._dispatch(addr, r.peers[addr], m)
        assert seen == []  # gated: 1000 blocks behind
        r.latest_height_fn = lambda: 1000
        await r._dispatch(addr, r.peers[addr], m)
        assert len(seen) == 1

    run(go())


def _fake_disconnect(r, dropped):
    async def fake_disconnect(addr):
        dropped.append(addr)
        r.peers.pop(addr, None)
    return fake_disconnect


def test_heartbeat_prover_cap():
    async def go():
        r = _router(max_peers=8)  # max_provers = 2
        for i in range(4):
            p = _peer_with_height(0, node_type=msg.NodeType.PROVER)
            p.first_seen = i  # oldest first
            r.peers[("10.0.0.%d" % i, 4130)] = p
        dropped = []
        r.tcp.disconnect = _fake_disconnect(r, dropped)
        await r._heartbeat()
        # the two oldest provers were evicted
        assert set(dropped) == {("10.0.0.0", 4130), ("10.0.0.1", 4130)}

    run(go())


def test_heartbeat_churns_oldest_at_max():
    async def go():
        r = _router(max_peers=3)
        for i in range(3):
            p = _peer_with_height(0)
            p.first_seen = 100 - i
            r.peers[("10.0.0.%d" % i, 4130)] = p
        r.candidate_peers.add(("10.9.9.9", 4130))
        dropped = []
        r.tcp.disconnect = _fake_disconnect(r, dropped)
        await r._heartbeat()
        # exactly one (the longest-connected) peer rotated out
        assert dropped == [("10.0.0.2", 4130)]

    run(go())


# -- worker redundant fetch ---------------------------------------------------


class _MockTransport:
    def __init__(self):
        self.sent = []  # (peer, event)

    def send(self, peer, event):
        self.sent.append((peer, event))
        return True


def _worker(num_validators=10):
    ledger = StubLedger(committee(num_validators))
    storage = NarwhalStorage(ledger, BFTMemoryService())
    transport = _MockTransport()
    return Worker(0, ledger, storage, transport), transport


def test_max_redundant_requests_cap():
    w, transport = _worker(num_validators=10)  # cap = 1 + 10 // 3 = 4
    assert w.max_redundant_requests() == 4
    tid = TransmissionID(0, b"\x07" * 32)
    # six distinct peers advertise the same missing transmission
    for i in range(6):
        w.process_worker_ping(("10.0.0.%d" % i, 5000), ev.WorkerPing((tid,)))
    reqs = [p for p, e in transport.sent if isinstance(e, ev.TransmissionRequest)]
    assert len(reqs) == 4  # capped at 1 + N / 3
    assert len(set(reqs)) == 4  # all to distinct peers


def test_redundant_requests_reset_after_expiry():
    w, transport = _worker(num_validators=3)  # cap = 2
    tid = TransmissionID(0, b"\x08" * 32)
    for i in range(3):
        w.process_worker_ping(("10.0.0.%d" % i, 5000), ev.WorkerPing((tid,)))
    assert len(transport.sent) == 2
    # force expiry: a later ping may re-request
    w.pending_expiry[tid] = time.time() - 1
    w.process_worker_ping(("10.0.0.9", 5000), ev.WorkerPing((tid,)))
    assert len(transport.sent) == 3


def test_same_peer_not_asked_twice():
    w, transport = _worker(num_validators=10)
    tid = TransmissionID(0, b"\x09" * 32)
    for _ in range(5):
        w.process_worker_ping(("10.0.0.1", 5000), ev.WorkerPing((tid,)))
    assert len(transport.sent) == 1


# -- the port's router against the JAX package's ---------------------------------


def _jax():
    from snarkos_tpu.node import codec as jcodec, messages as jmsg, router as jrouter

    return jcodec, jmsg, jrouter


async def _pair(dialer_cls, listener_cls, dialer_type, listener_type, ports=None):
    """A router of ``dialer_cls`` (dev account 0) dials one of
    ``listener_cls`` (dev account 1); with ``ports`` each announces that
    listening port in place of its own."""
    dialer = dialer_cls(account(0), dialer_type, GENESIS)
    listener = listener_cls(account(1), listener_type, GENESIS)
    await dialer.run()
    addr = await listener.run()
    if ports is not None:
        dialer.tcp.listening_addr = ("127.0.0.1", ports[0])
        listener.tcp.listening_addr = ("127.0.0.1", ports[1])
    ok = await dialer.connect(addr)
    return dialer, listener, addr, ok


@pytest.mark.parametrize("port_dials", [True, False], ids=["port-dials", "jax-dials"])
def test_handshake_with_jax_router(port_dials):
    _, jmsg, jrouter = _jax()

    async def go():
        classes = (Router, jrouter.Router) if port_dials else (jrouter.Router, Router)
        dialer, listener, addr, ok = await _pair(*classes, msg.NodeType.VALIDATOR,
                                                 msg.NodeType.CLIENT)
        try:
            assert ok
            assert await until(lambda: listener.number_of_connected_peers() == 1)
            (dp,) = dialer.peers.values()
            (lp,) = listener.peers.values()
            assert (dp.address, dp.node_type, dp.listening_addr) == (
                account(1).address, msg.NodeType.CLIENT, addr)
            assert (lp.address, lp.node_type) == (account(0).address,
                                                  msg.NodeType.VALIDATOR)
            assert lp.listening_addr == ("127.0.0.1", dialer.local_addr[1])
        finally:
            await dialer.shut_down()
            await listener.shut_down()

    run(go())


def test_router_frames_equal_jax_bytes(monkeypatch):
    jcodec, jmsg, jrouter = _jax()
    monkeypatch.setattr(secrets, "randbits", handshake_nonce)
    monkeypatch.setattr(secrets, "randbelow", lambda n: 0x5EED5EED % n)
    sent = {"port": [], "jax": []}
    for mod, side in ((codec, "port"), (jcodec, "jax")):
        real = mod.write_frame

        def record(writer, payload, max_len, real=real, side=side):
            sent[side].append(bytes(payload))
            return real(writer, payload, max_len)

        monkeypatch.setattr(mod, "write_frame", record)
    locators = msg.BlockLocators(recents=((0, b"\x22" * 32), (1, b"\x33" * 32)),
                                 checkpoints=((0, b"\x22" * 32),))
    jlocators = jmsg.BlockLocators(recents=locators.recents, checkpoints=locators.checkpoints)

    async def exchange(port_dials):
        for v in sent.values():
            v.clear()
        classes = (Router, jrouter.Router) if port_dials else (jrouter.Router, Router)
        dialer, listener, addr, ok = await _pair(*classes, msg.NodeType.CLIENT,
                                                 msg.NodeType.VALIDATOR, ports=(4130, 4131))
        try:
            assert ok
            ping = (msg if dialer.__class__ is Router else jmsg).Ping(
                msg.VERSION, msg.NodeType.CLIENT, locators if port_dials else jlocators)
            assert dialer.send(addr, ping)
            # the listener answers the Ping with a Pong: three frames each way
            # (a heartbeat's frames would come after them)
            assert await until(lambda: len(sent["port"]) >= 3 and len(sent["jax"]) >= 3)
        finally:
            await dialer.shut_down()
            await listener.shut_down()
        return {k: v[:3] for k, v in sent.items()}

    port_first = run(exchange(True))
    jax_first = run(exchange(False))
    assert port_first["port"] == jax_first["jax"]  # the dialer's frames
    assert port_first["jax"] == jax_first["port"]  # the listener's frames
    kinds = [type(msg.deserialize(f)).__name__ for f in port_first["port"]]
    assert kinds == ["ChallengeRequest", "ChallengeResponse", "Ping"]
    assert [type(msg.deserialize(f)).__name__ for f in port_first["jax"]] == [
        "ChallengeRequest", "ChallengeResponse", "Pong"]
