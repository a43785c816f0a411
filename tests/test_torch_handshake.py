"""Protocol-conformance probes of the port's router and gateway with a raw
TestPeer over the port's codec, case for case the JAX package's
tests/test_handshake_conformance.py: the handshake's order, malformed and
oversized frames, the version gate, wrong signatures and genesis, the
responder and initiator matrices over the three node roles, simultaneous
and duplicate dials, a malformed frame after the handshake, and the
gateway's refusal of an event other than the challenge request first.

Where the reference tests sleep a fixed time, these wait for what the
router does: a refused peer sees its socket closed (EOF), an accepted one
shows up in the peer table, each under a limit. The happy path and the
wrong-signer case sign with the real (pure-Python) Schnorr signatures; the
other cases with ``torch_bft_support``'s keyed-hash stand-in, which also
tells one signer from another."""

import asyncio

import pytest

from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import codec, events as ev, messages as msg
from snarkos_tpu_torch.node.gateway import Gateway
from snarkos_tpu_torch.node.router import Router

from torch_bft_support import StubLedger, standin_sign, standin_verify
from torch_net_support import account, closed_by_peer, committee, run, until

GENESIS = b"\x11" * 32
ROLES = [msg.NodeType.CLIENT, msg.NodeType.PROVER, msg.NodeType.VALIDATOR]


@pytest.fixture()
def standin_signatures(monkeypatch):
    monkeypatch.setattr(edwards, "sign_bytes", standin_sign)
    monkeypatch.setattr(edwards, "verify_bytes", standin_verify)


async def _router(node_type=msg.NodeType.VALIDATOR, index=0):
    r = Router(account(index), node_type, GENESIS)
    await r.run()
    return r


async def _send(writer, m):
    codec.write_frame(writer, msg.serialize(m), codec.MAX_FRAME_HANDSHAKE)
    await writer.drain()


async def _recv(reader):
    return msg.deserialize(await codec.read_frame(reader, codec.MAX_FRAME_HANDSHAKE))


def _sign(acct, peer_nonce, my_nonce):
    return edwards.sign_bytes(acct.sk, acct.pk, peer_nonce.to_bytes(8, "little")
                              + my_nonce.to_bytes(8, "little"))


async def _peer_complete_handshake(addr, peer_acct, peer_type, genesis=GENESIS,
                                   sign_with=None, listener_port=1234):
    """Raw TestPeer initiator: runs the full challenge/response exchange."""
    reader, writer = await asyncio.open_connection(*addr)
    my_nonce = 77
    await _send(writer, msg.ChallengeRequest(msg.VERSION, listener_port, peer_type,
                                             peer_acct.address, my_nonce))
    peer_req = await _recv(reader)
    sig = _sign(sign_with or peer_acct, peer_req.nonce, my_nonce)
    await _send(writer, msg.ChallengeResponse(genesis, b"\x00" * 32, sig, my_nonce))
    return reader, writer


def test_responder_handshake_happy_path():
    """A raw TestPeer completes the router's handshake byte for byte, with
    real signatures, and reads a response that verifies."""
    async def go():
        router = await _router()
        try:
            peer_acct = account(1)
            reader, writer = await asyncio.open_connection(*router.local_addr)
            my_nonce = 42
            await _send(writer, msg.ChallengeRequest(msg.VERSION, 1234, msg.NodeType.CLIENT,
                                                     peer_acct.address, my_nonce))
            peer_req = await _recv(reader)
            assert isinstance(peer_req, msg.ChallengeRequest)
            assert peer_req.address == account(0).address
            await _send(writer, msg.ChallengeResponse(
                GENESIS, b"\x00" * 32, _sign(peer_acct, peer_req.nonce, my_nonce), my_nonce))
            peer_resp = await _recv(reader)
            assert isinstance(peer_resp, msg.ChallengeResponse)
            assert edwards.verify_bytes(account(0).pk, my_nonce.to_bytes(8, "little")
                                        + peer_resp.nonce.to_bytes(8, "little"),
                                        peer_resp.signature)
            assert await until(lambda: router.number_of_connected_peers() == 1)
            writer.close()
        finally:
            await router.shut_down()

    run(go())


def test_wrong_first_message_rejected(standin_signatures):
    """A Ping before the challenge handshake must not connect."""
    async def go():
        router = await _router()
        try:
            reader, writer = await asyncio.open_connection(*router.local_addr)
            await _send(writer, msg.Ping(msg.VERSION, 0, None))
            assert await closed_by_peer(reader)
            assert router.number_of_connected_peers() == 0
            writer.close()
        finally:
            await router.shut_down()

    run(go())


def test_outdated_version_rejected(standin_signatures):
    async def go():
        router = await _router()
        try:
            reader, writer = await asyncio.open_connection(*router.local_addr)
            await _send(writer, msg.ChallengeRequest(0, 1234, msg.NodeType.CLIENT,
                                                     account(1).address, 1))
            assert await closed_by_peer(reader)
            assert router.number_of_connected_peers() == 0
            writer.close()
        finally:
            await router.shut_down()

    run(go())


def test_garbage_frame_rejected(standin_signatures):
    async def go():
        router = await _router()
        try:
            reader, writer = await asyncio.open_connection(*router.local_addr)
            writer.write(b"\xff\xff\xff\x7f")  # an insane length prefix
            await writer.drain()
            assert await closed_by_peer(reader)
            assert router.number_of_connected_peers() == 0
            writer.close()
        finally:
            await router.shut_down()

    run(go())


def test_oversized_handshake_frame_rejected(standin_signatures):
    async def go():
        router = await _router()
        try:
            reader, writer = await asyncio.open_connection(*router.local_addr)
            # a 2 MiB frame during the handshake (the cap is 1 MiB)
            writer.write((2 * 1024 * 1024).to_bytes(4, "little") + b"\x00" * 1024)
            await writer.drain()
            assert await closed_by_peer(reader)
            assert router.number_of_connected_peers() == 0
            writer.close()
        finally:
            await router.shut_down()

    run(go())


@pytest.mark.parametrize("node_type", ROLES, ids=["client", "prover", "validator"])
@pytest.mark.parametrize("peer_type", ROLES, ids=["p-client", "p-prover", "p-validator"])
def test_responder_matrix(standin_signatures, node_type, peer_type):
    """The responder grid (handshake.rs:95-283): every node role completes the
    handshake with every peer role (the TestPeer dials)."""
    async def go():
        router = await _router(node_type)
        try:
            reader, writer = await _peer_complete_handshake(
                router.local_addr, account(1), peer_type)
            assert isinstance(await _recv(reader), msg.ChallengeResponse)
            assert await until(lambda: router.number_of_connected_peers() == 1)
            (peer,) = router.peers.values()
            assert peer.node_type == peer_type
            assert peer.listening_addr == ("127.0.0.1", 1234)
            writer.close()
        finally:
            await router.shut_down()

    run(go())


@pytest.mark.parametrize("node_type", ROLES, ids=["client", "prover", "validator"])
@pytest.mark.parametrize("variant", ["good", "bad_sig", "wrong_genesis"])
def test_initiator_matrix(standin_signatures, node_type, variant):
    """The initiator grid: the node dials a raw TestPeer listener; a correct
    responder connects, a forged signature or a wrong genesis must not."""
    peer_acct, wrong_acct = account(1), account(2)

    async def go():
        router = await _router(node_type)
        done = asyncio.Event()

        async def peer_server(reader, writer):
            try:
                peer_req = await _recv(reader)
                my_nonce = 99
                await _send(writer, msg.ChallengeRequest(msg.VERSION, 4242, msg.NodeType.CLIENT,
                                                         peer_acct.address, my_nonce))
                assert isinstance(await _recv(reader), msg.ChallengeResponse)
                signer = wrong_acct if variant == "bad_sig" else peer_acct
                genesis = b"\x99" * 32 if variant == "wrong_genesis" else GENESIS
                await _send(writer, msg.ChallengeResponse(
                    genesis, b"\x00" * 32, _sign(signer, peer_req.nonce, my_nonce), my_nonce))
            except Exception:
                pass
            finally:
                done.set()

        server = await asyncio.start_server(peer_server, "127.0.0.1", 0)
        addr = server.sockets[0].getsockname()[:2]
        try:
            ok = await router.connect(addr)
            await asyncio.wait_for(done.wait(), 5)
            if variant == "good":
                assert ok and router.number_of_connected_peers() == 1
            else:
                assert not ok and router.number_of_connected_peers() == 0
        finally:
            server.close()
            await router.shut_down()

    run(go())


def test_bad_signature_rejected_responder_side():
    """A TestPeer initiator signing with the WRONG key (real signatures) must
    be refused."""
    async def go():
        router = await _router()
        try:
            reader, writer = await _peer_complete_handshake(
                router.local_addr, account(1), msg.NodeType.CLIENT,
                sign_with=account(2))
            assert await closed_by_peer(reader)
            assert router.number_of_connected_peers() == 0
            writer.close()
        finally:
            await router.shut_down()

    run(go())


def test_wrong_genesis_rejected_responder_side(standin_signatures):
    async def go():
        router = await _router()
        try:
            reader, writer = await _peer_complete_handshake(
                router.local_addr, account(1), msg.NodeType.CLIENT, genesis=b"\x55" * 32)
            assert await closed_by_peer(reader)
            assert router.number_of_connected_peers() == 0
            writer.close()
        finally:
            await router.shut_down()

    run(go())


def test_simultaneous_connect(standin_signatures):
    """Both routers dial each other at once: no deadlock, both end up
    connected."""
    async def go():
        r1 = await _router(msg.NodeType.VALIDATOR, 0)
        r2 = await _router(msg.NodeType.CLIENT, 1)
        try:
            await asyncio.gather(r1.connect(r2.local_addr), r2.connect(r1.local_addr),
                                 return_exceptions=True)
            assert await until(lambda: r1.number_of_connected_peers() >= 1
                               and r2.number_of_connected_peers() >= 1)
        finally:
            await r1.shut_down()
            await r2.shut_down()

    run(go())


def test_duplicate_connect_refused(standin_signatures):
    """A second dial to a connected listener is refused without disturbing the
    live connection (tcp.rs:205-264)."""
    async def go():
        r1 = await _router(msg.NodeType.VALIDATOR, 0)
        r2 = await _router(msg.NodeType.CLIENT, 1)
        try:
            assert await r1.connect(r2.local_addr)
            assert await until(lambda: r2.number_of_connected_peers() == 1)
            before = r1.number_of_connected_peers()
            assert not await r1.connect(r2.local_addr)
            assert r1.number_of_connected_peers() == before == 1
        finally:
            await r1.shut_down()
            await r2.shut_down()

    run(go())


def test_malformed_frame_post_handshake_disconnects(standin_signatures):
    """A garbage length prefix after a completed handshake is a fatal protocol
    error: the peer is dropped and its failure counter bumped."""
    async def go():
        router = await _router()
        try:
            reader, writer = await _peer_complete_handshake(
                router.local_addr, account(1), msg.NodeType.CLIENT)
            await codec.read_frame(reader, codec.MAX_FRAME_HANDSHAKE)
            assert await until(lambda: router.number_of_connected_peers() == 1)
            writer.write((0x7FFFFFFF).to_bytes(4, "little"))
            await writer.drain()
            assert await until(lambda: router.number_of_connected_peers() == 0)
            assert any(st.failures > 0 for st in router.tcp.stats.values())
            writer.close()
        finally:
            await router.shut_down()

    run(go())


def test_gateway_wrong_order_handshake(standin_signatures):
    """Gateway: an event other than the challenge request first: no
    connection."""
    async def go():
        gw = Gateway(account(0), StubLedger(committee(2)))
        await gw.run()
        try:
            reader, writer = await asyncio.open_connection(*gw.local_addr)
            codec.write_frame(writer, ev.serialize(ev.ValidatorsRequest()),
                              codec.MAX_FRAME_HANDSHAKE)
            await writer.drain()
            assert await closed_by_peer(reader)
            assert len(gw.connected_validators) == 0
            writer.close()
        finally:
            await gw.shut_down()

    run(go())
