"""The port's TCP stack (snarkos_tpu_torch/node/tcp.py), case for case the
JAX package's tests/test_tcp.py: connect and disconnect, self-connect and
duplicate refusal, the connection limit, a failing and a stalling
handshake, unicast, broadcast and stats, the frame cap, a peer's
disconnect and the frame codec. Polls with a limit replace the reference
tests' fixed sleeps; no timing is asserted. Then a port ``Tcp`` and a JAX
one exchange frames over one socket both ways."""

import asyncio

import pytest

from snarkos_tpu_torch.node import codec
from snarkos_tpu_torch.node.tcp import Tcp, TcpConfig

from torch_net_support import run, until


def test_connect_disconnect_roundtrip():
    async def go():
        a, b = Tcp(name="a"), Tcp(name="b")
        addr_b = await b.enable_listener()
        await a.connect(addr_b)
        assert a.num_connected == 1
        # the responder registers too (no handshake: at once)
        assert await until(lambda: b.num_connected == 1)
        await a.disconnect(addr_b)
        assert a.num_connected == 0
        await a.shut_down()
        await b.shut_down()

    run(go())


def test_self_connect_refused():
    async def go():
        a = Tcp(name="a")
        addr = await a.enable_listener()
        with pytest.raises(ConnectionError, match="self"):
            await a.connect(addr)
        await a.shut_down()

    run(go())


def test_duplicate_connect_refused():
    async def go():
        a, b = Tcp(name="a"), Tcp(name="b")
        addr_b = await b.enable_listener()
        await a.connect(addr_b)
        with pytest.raises(ConnectionError, match="already connected"):
            await a.connect(addr_b)
        await a.shut_down()
        await b.shut_down()

    run(go())


def test_max_connections_enforced():
    async def go():
        server = Tcp(TcpConfig(max_connections=2), name="server")
        await server.enable_listener()
        clients = [Tcp(name=f"c{i}") for i in range(3)]
        for c in clients:
            await c.enable_listener()
            await c.connect(server.listening_addr)
        # the server closes the third socket: that client's read loop ends
        assert await until(lambda: sum(c.num_connected for c in clients) == 2)
        assert server.num_connected == 2
        for c in clients:
            await c.shut_down()
        await server.shut_down()

    run(go())


def test_handshake_failure_rejects_connection():
    async def failing_handshake(conn):
        raise ConnectionError("nope")

    async def go():
        server = Tcp(name="server")
        server.handshake = failing_handshake
        await server.enable_listener()
        client = Tcp(name="client")
        client.handshake = failing_handshake
        with pytest.raises(ConnectionError, match="nope"):
            await client.connect(server.listening_addr)
        assert client.num_connected == 0
        assert client.stats[server.listening_addr].failures == 1
        assert await until(lambda: sum(s.failures for s in server.stats.values()) == 1)
        assert server.num_connected == 0
        await client.shut_down()
        await server.shut_down()

    run(go())


def test_handshake_timeout_enforced():
    async def stalling_handshake(conn):
        await asyncio.sleep(30)

    async def go():
        server = Tcp(name="server")
        await server.enable_listener()
        client = Tcp(TcpConfig(handshake_timeout_s=0.1), name="client")
        client.handshake = stalling_handshake
        with pytest.raises(asyncio.TimeoutError):
            await client.connect(server.listening_addr)
        assert client.num_connected == 0
        await client.shut_down()
        await server.shut_down()

    run(go())


def test_unicast_broadcast_and_stats():
    async def go():
        received = []

        async def on_msg(addr, payload):
            received.append((addr, payload))

        server = Tcp(name="server")
        server.process_message = on_msg
        await server.enable_listener()
        c1, c2 = Tcp(name="c1"), Tcp(name="c2")
        await c1.connect(server.listening_addr)
        await c2.connect(server.listening_addr)
        assert c1.unicast(server.listening_addr, b"hello")
        assert c2.broadcast(b"world") == 1
        assert await until(lambda: len(received) == 2)
        assert sorted(p for _, p in received) == [b"hello", b"world"]
        assert await until(lambda: c1.stats[server.listening_addr].sent_msgs == 1)
        st = c1.stats[server.listening_addr]
        assert st.sent_bytes == len(b"hello") + 4
        got = [st for st in server.stats.values() if st.recv_msgs]
        assert sorted(st.recv_bytes for st in got) == [len(b"hello") + 4, len(b"world") + 4]
        await c1.shut_down()
        await c2.shut_down()
        await server.shut_down()

    run(go())


def test_oversize_frame_disconnects():
    async def go():
        server = Tcp(TcpConfig(max_frame_size=64), name="server")
        await server.enable_listener()
        client = Tcp(name="client")
        await client.connect(server.listening_addr)
        assert await until(lambda: server.num_connected == 1)
        client.unicast(server.listening_addr, b"x" * 128)  # over the server's cap
        assert await until(lambda: server.num_connected == 0)  # its reader dropped the peer
        assert sum(st.failures for st in server.stats.values()) == 1
        await client.shut_down()
        await server.shut_down()

    run(go())


def test_peer_disconnect_cleans_up():
    async def go():
        events = []

        async def on_disc(addr):
            events.append(addr)

        server = Tcp(name="server")
        server.on_disconnect = on_disc
        await server.enable_listener()
        client = Tcp(name="client")
        await client.connect(server.listening_addr)
        assert await until(lambda: server.num_connected == 1)
        await client.shut_down()
        assert await until(lambda: server.num_connected == 0)
        assert await until(lambda: len(events) == 1)
        await server.shut_down()

    run(go())


def test_frame_codec_roundtrip_and_limits():
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data((3).to_bytes(4, "little") + b"abc")
        assert await codec.read_frame(reader, 64) == b"abc"
        reader.feed_data((1 << 29).to_bytes(4, "little"))
        with pytest.raises(codec.FrameError):
            await codec.read_frame(reader, codec.MAX_FRAME_ROUTER // 4)

    run(go())


@pytest.mark.parametrize("port_dials", [True, False], ids=["port-dials", "jax-dials"])
def test_frames_cross_the_jax_stack(port_dials):
    """A port ``Tcp`` and the JAX package's exchange frames over one
    socket, each way, with the same length prefix and stats."""
    from snarkos_tpu.node import tcp as jtcp

    async def go():
        got = {"port": [], "jax": []}

        def sink(side):
            async def on_msg(addr, payload):
                got[side].append(payload)
            return on_msg

        port, jax = Tcp(name="port"), jtcp.Tcp(name="jax")
        port.process_message, jax.process_message = sink("port"), sink("jax")
        dialer, listener = (port, jax) if port_dials else (jax, port)
        addr = await listener.enable_listener()
        await dialer.connect(addr)
        assert await until(lambda: listener.num_connected == 1)
        back = next(iter(listener.connections))
        assert dialer.unicast(addr, b"\x00" * 5 + b"to the listener")
        assert listener.unicast(back, b"to the dialer" + b"\xff" * 300)
        assert await until(lambda: got["port"] and got["jax"])
        listened = "jax" if port_dials else "port"
        dialed = "port" if port_dials else "jax"
        assert got[listened] == [b"\x00" * 5 + b"to the listener"]
        assert got[dialed] == [b"to the dialer" + b"\xff" * 300]
        assert await until(lambda: dialer.stats[addr].sent_bytes == 4 + 20)
        assert listener.stats[back].recv_bytes == 4 + 20
        await dialer.shut_down()
        await listener.shut_down()

    run(go())
