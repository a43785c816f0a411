"""The port's gateway (snarkos_tpu_torch/node/gateway.py), case for case the
JAX package's tests/test_gateway_limits.py: a peer that floods events is
disconnected, normal traffic is not. There the handshakes sign with
``torch_bft_support``'s keyed-hash stand-in for the pure-Python Schnorr
signatures, and the gateways stand on its ``StubLedger``.

Then the port's gateway against the JAX package's over localhost, with real
signatures: the committee-gated handshake completes with either side
dialing, and with its randomness and the announced listening ports fixed,
every frame the port sends in a role (the challenge request and response,
a ValidatorsRequest, the ValidatorsResponse) is byte for byte the frame
the JAX gateway sends in that role."""

import secrets

import pytest

from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import codec, events as ev
from snarkos_tpu_torch.node.gateway import CACHE_EVENTS_PER_PEER, Gateway

from torch_bft_support import StubLedger, standin_sign, standin_verify
from torch_net_support import account, committee, handshake_nonce, run, until


@pytest.fixture()
def standin_signatures(monkeypatch):
    monkeypatch.setattr(edwards, "sign_bytes", standin_sign)
    monkeypatch.setattr(edwards, "verify_bytes", standin_verify)


async def _pair(classes=(Gateway, Gateway), ports=None):
    """Gateways of dev accounts 0 and 1 over the dev committee of 2; the first
    dials the second; with ``ports`` each announces that listening port."""
    gws = []
    for i, cls in enumerate(classes):
        g = cls(account(i), StubLedger(committee(2)))
        await g.run()
        gws.append(g)
    addr = gws[1].local_addr
    if ports is not None:
        for g, p in zip(gws, ports):
            g.tcp.listening_addr = ("127.0.0.1", p)
    await gws[0].connect_to(addr)
    assert await until(lambda: gws[0].connected_validators and gws[1].connected_validators)
    return gws, addr


def test_event_flood_disconnects(standin_signatures):
    async def go():
        (g0, g1), _ = await _pair()
        try:
            assert len(g1.connected_validators) == 1
            for _ in range(CACHE_EVENTS_PER_PEER + 50):
                g0.broadcast(ev.ValidatorsRequest())
            assert await until(lambda: not g1.connected_validators, 5.0), \
                "the flooder was not disconnected"
        finally:
            await g0.shut_down()
            await g1.shut_down()

    run(go())


def test_normal_traffic_not_limited(standin_signatures):
    async def go():
        (g0, g1), _ = await _pair()
        try:
            (addr,) = g1.connected_validators
            for _ in range(20):
                g0.broadcast(ev.ValidatorsRequest())
            # all 20 reached g1's rate cache, and it kept the connection
            assert await until(lambda: len(g1.rate_cache.counters[("events", addr)]) == 20)
            assert len(g1.rate_cache.counters[("requests", addr)]) == 20
            assert len(g1.connected_validators) == 1
            assert await until(lambda: g0.tcp.stats[g0.resolver[account(1).address]]
                               .recv_msgs == 20)
            assert len(g0.connected_validators) == 1
        finally:
            await g0.shut_down()
            await g1.shut_down()

    run(go())


# -- the port's gateway against the JAX package's ----------------------------------


def _jax():
    from snarkos_tpu.node import codec as jcodec, events as jev, gateway as jgateway

    return jcodec, jev, jgateway


@pytest.mark.parametrize("port_dials", [True, False], ids=["port-dials", "jax-dials"])
def test_handshake_with_jax_gateway(port_dials):
    _, _, jgateway = _jax()

    async def go():
        classes = (Gateway, jgateway.Gateway) if port_dials else (jgateway.Gateway, Gateway)
        (dialer, listener), addr = await _pair(classes)
        try:
            assert list(dialer.connected_validators.values()) == [account(1).address]
            assert list(listener.connected_validators.values()) == [account(0).address]
            assert dialer.resolver[account(1).address] == addr
            (back,) = listener.listener_addrs.values()
            assert back == ("127.0.0.1", dialer.local_addr[1])
        finally:
            await dialer.shut_down()
            await listener.shut_down()

    run(go())


def test_gateway_frames_equal_jax_bytes(monkeypatch):
    jcodec, jev, jgateway = _jax()
    monkeypatch.setattr(secrets, "randbits", handshake_nonce)
    monkeypatch.setattr(secrets, "randbelow", lambda n: 0xC0FFEE % n)
    sent = {"port": [], "jax": []}
    for mod, side in ((codec, "port"), (jcodec, "jax")):
        real = mod.write_frame

        def record(writer, payload, max_len, real=real, side=side):
            sent[side].append(bytes(payload))
            return real(writer, payload, max_len)

        monkeypatch.setattr(mod, "write_frame", record)

    async def exchange(port_dials):
        for v in sent.values():
            v.clear()
        classes = (Gateway, jgateway.Gateway) if port_dials else (jgateway.Gateway, Gateway)
        (dialer, listener), _ = await _pair(classes, ports=(5000, 5001))
        try:
            request = (ev if port_dials else jev).ValidatorsRequest()
            assert dialer.send(account(1).address, request)
            # the listener answers with a ValidatorsResponse: three frames each way
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
    names = [[type(ev.deserialize(f)).__name__ for f in port_first[k]] for k in ("port", "jax")]
    assert names == [["GatewayChallengeRequest", "GatewayChallengeResponse", "ValidatorsRequest"],
                     ["GatewayChallengeRequest", "GatewayChallengeResponse", "ValidatorsResponse"]]
    assert ev.deserialize(port_first["jax"][2]).validators == (
        ("127.0.0.1", 5000, account(0).address),)
