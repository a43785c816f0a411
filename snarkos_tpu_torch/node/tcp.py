"""Reusable asyncio TCP stack with opt-in protocol hooks.

Re-creates the reference's `node/tcp` crate semantics (SURVEY.md §2.1;
node/tcp/src/tcp.rs:53-505): connection lifecycle with self-connect /
duplicate / limit checks, a listener, and pluggable protocol hooks —
handshake, per-connection reading loop, writing (unicast/broadcast),
on-connect, on-disconnect — plus per-peer and global byte/message stats.

Hardening semantics carried over from the reference stack:

- **Fatal-io classification** (config.rs fatal io errors): read/write
  errors are split into *fatal* (peer gone / protocol violation — the
  connection is torn down and the peer's failure counter bumped) and
  *benign* shutdown races (cancellation during our own disconnect).
- **Reading backpressure** (protocols/reading.rs MESSAGE_QUEUE_DEPTH):
  each connection owns a bounded inbound queue drained by a dedicated
  processing task, so one slow message handler cannot stall frame
  decoding; when the queue is full the frame is DROPPED with a warning
  and counted as a failure (the reference logs and drops likewise).
- **Handshake framing cap** (codec.rs: 1 MiB during handshake vs the
  plane's full cap after): `Connection.handshake_frame()` reads with the
  reduced limit; the full limit applies only after `_adapt` installs the
  reading task.
- **Split-stream ownership** (protocols/handshake.rs borrow_stream /
  take_stream): the handshake hook owns the reader/writer exclusively
  until it returns — the reading/writing tasks are spawned strictly
  afterwards, so a handshake never races the framed read loop.

A concrete node plane (router or gateway) subclasses/instantiates ``Tcp``
and supplies the hooks.

The port of ``snarkos_tpu/node/tcp.py``: the same framing, limits and
hooks, so a port plane and a JAX one talk over one socket. It holds no
tensor.
"""

from __future__ import annotations

import asyncio
import errno
import logging
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

from snarkos_tpu_torch.node import codec

log = logging.getLogger(__name__)

# handshake-time frame cap (messages/src/helpers/codec.rs:24-27: 1 MiB
# during handshake, plane cap afterwards)
MAX_HANDSHAKE_FRAME = 1 << 20

# errno values treated as FATAL io errors (the reference's configurable
# fatal set covers ConnectionReset/Aborted/BrokenPipe/UnexpectedEof)
_FATAL_ERRNOS = {
    errno.ECONNRESET, errno.ECONNABORTED, errno.EPIPE, errno.ENOTCONN,
    errno.ESHUTDOWN, errno.ETIMEDOUT, errno.EHOSTUNREACH, errno.ENETDOWN,
    errno.ENETUNREACH, errno.ENETRESET,
}


def classify_io_error(exc: BaseException) -> str:
    """'fatal' | 'protocol' | 'benign' — drives failure accounting.

    fatal: the transport died under us (peer reset, broken pipe, EOF).
    protocol: the peer VIOLATED framing (oversized/malformed frame).
    benign: our own shutdown/cancellation races.
    """
    if isinstance(exc, codec.FrameError):
        return "protocol"
    if isinstance(exc, (asyncio.IncompleteReadError, ConnectionResetError,
                        BrokenPipeError, ConnectionAbortedError, EOFError)):
        return "fatal"
    if isinstance(exc, OSError):
        return "fatal" if exc.errno in _FATAL_ERRNOS else "benign"
    if isinstance(exc, asyncio.CancelledError):
        return "benign"
    return "fatal"


@dataclass
class TcpConfig:
    """node/tcp/src/helpers/config.rs:26-91 equivalents."""

    listener_ip: str = "127.0.0.1"
    desired_listening_port: int = 0
    max_connections: int = 100
    connection_timeout_s: float = 1.0
    handshake_timeout_s: float = 3.0
    max_frame_size: int = codec.MAX_FRAME_ROUTER
    message_queue_depth: int = 1024


@dataclass
class PeerStats:
    sent_msgs: int = 0
    sent_bytes: int = 0
    recv_msgs: int = 0
    recv_bytes: int = 0
    failures: int = 0
    dropped_msgs: int = 0  # inbound-queue overflow drops
    first_seen: float = field(default_factory=time.time)
    last_seen: float = field(default_factory=time.time)


class Connection:
    """One live connection. During the handshake the hook owns the
    reader/writer exclusively (reference take_stream/borrow_stream); the
    framed read/write/process tasks start only after the handshake
    returns."""

    def __init__(self, addr: tuple[str, int], reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, side: str,
                 queue_depth: int = 1024):
        self.addr = addr  # the remote (ip, port) of the socket
        self.reader = reader
        self.writer = writer
        self.side = side  # "initiator" | "responder"
        self.send_queue: asyncio.Queue = asyncio.Queue(maxsize=queue_depth)
        self.recv_queue: asyncio.Queue = asyncio.Queue(maxsize=queue_depth)
        self.tasks: list[asyncio.Task] = []
        self.closed = asyncio.Event()

    async def handshake_frame(self) -> bytes:
        """Read one frame under the HANDSHAKE cap (1 MiB)."""
        return await codec.read_frame(self.reader, MAX_HANDSHAKE_FRAME)


class Tcp:
    """Connection lifecycle + protocol hook dispatch.

    Hooks (all optional, set before ``enable_listener``):
      handshake(conn) -> awaitable raising on failure
      process_message(addr, payload: bytes) -> awaitable
      on_connect(addr) / on_disconnect(addr) -> awaitable
    """

    def __init__(self, config: TcpConfig | None = None, name: str = "node"):
        self.config = config or TcpConfig()
        self.name = name
        self.connections: dict[tuple[str, int], Connection] = {}
        self.connecting: set[tuple[str, int]] = set()
        self.stats: dict[tuple[str, int], PeerStats] = {}
        self.listener: Optional[asyncio.AbstractServer] = None
        self.listening_addr: Optional[tuple[str, int]] = None
        # protocol hooks
        self.handshake: Optional[Callable[[Connection], Awaitable[None]]] = None
        self.process_message: Optional[Callable[[tuple[str, int], bytes], Awaitable[None]]] = None
        self.on_connect: Optional[Callable[[tuple[str, int]], Awaitable[None]]] = None
        self.on_disconnect: Optional[Callable[[tuple[str, int]], Awaitable[None]]] = None

    # -- queries -------------------------------------------------------------
    @property
    def num_connected(self) -> int:
        return len(self.connections)

    def is_connected(self, addr: tuple[str, int]) -> bool:
        return addr in self.connections

    def is_self(self, addr: tuple[str, int]) -> bool:
        return self.listening_addr is not None and addr == self.listening_addr

    # -- lifecycle -----------------------------------------------------------
    async def enable_listener(self) -> tuple[str, int]:
        assert self.listener is None
        server = await asyncio.start_server(
            self._accept, self.config.listener_ip, self.config.desired_listening_port
        )
        self.listener = server
        sock = server.sockets[0]
        self.listening_addr = sock.getsockname()[:2]
        log.debug("%s: listening on %s", self.name, self.listening_addr)
        return self.listening_addr

    async def connect(self, addr: tuple[str, int]) -> None:
        """node/tcp/src/tcp.rs:205-264 semantics: refuse self-connects,
        duplicates, in-flight duplicates, and over-limit connections."""
        addr = (addr[0], int(addr[1]))
        if self.is_self(addr):
            raise ConnectionError("cannot connect to self")
        if addr in self.connections:
            raise ConnectionError(f"already connected to {addr}")
        if addr in self.connecting:
            raise ConnectionError(f"already connecting to {addr}")
        if self.num_connected >= self.config.max_connections:
            raise ConnectionError("maximum number of connections reached")
        self.connecting.add(addr)
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(*addr), self.config.connection_timeout_s
            )
            conn = Connection(addr, reader, writer, "initiator",
                              self.config.message_queue_depth)
            await self._adapt(conn)
        except Exception:
            self._bump_failure(addr)
            raise
        finally:
            self.connecting.discard(addr)

    async def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        addr = writer.get_extra_info("peername")[:2]
        if self.num_connected >= self.config.max_connections:
            writer.close()
            return
        conn = Connection(addr, reader, writer, "responder",
                          self.config.message_queue_depth)
        try:
            await self._adapt(conn)
        except Exception as exc:
            log.debug("%s: failed to accept %s: %s", self.name, addr, exc)
            self._bump_failure(addr)
            writer.close()

    async def _adapt(self, conn: Connection) -> None:
        """Handshake (exclusive stream ownership), then spawn the
        read/process/write tasks (node/tcp/src/tcp.rs:429-504)."""
        if self.handshake is not None:
            await asyncio.wait_for(self.handshake(conn), self.config.handshake_timeout_s)
        self.connections[conn.addr] = conn
        self.stats.setdefault(conn.addr, PeerStats())
        conn.tasks.append(asyncio.create_task(self._read_loop(conn)))
        conn.tasks.append(asyncio.create_task(self._process_loop(conn)))
        conn.tasks.append(asyncio.create_task(self._write_loop(conn)))
        if self.on_connect is not None:
            await self.on_connect(conn.addr)

    async def disconnect(self, addr: tuple[str, int]) -> None:
        conn = self.connections.pop(addr, None)
        if conn is None:
            return
        for t in conn.tasks:
            t.cancel()
        try:
            conn.writer.close()
        except Exception:
            pass
        conn.closed.set()
        if self.on_disconnect is not None:
            await self.on_disconnect(addr)

    async def shut_down(self) -> None:
        if self.listener is not None:
            self.listener.close()
            self.listener = None
        for addr in list(self.connections):
            await self.disconnect(addr)

    # -- IO ------------------------------------------------------------------
    def unicast(self, addr: tuple[str, int], payload: bytes) -> bool:
        conn = self.connections.get(addr)
        if conn is None:
            return False
        try:
            conn.send_queue.put_nowait(payload)
        except asyncio.QueueFull:
            log.warning("%s: send queue full for %s, dropping", self.name, addr)
            return False
        return True

    def broadcast(self, payload: bytes, exclude: set | None = None) -> int:
        count = 0
        for addr in list(self.connections):
            if exclude and addr in exclude:
                continue
            if self.unicast(addr, payload):
                count += 1
        return count

    async def _read_loop(self, conn: Connection) -> None:
        """Frame decoding only; handling happens in _process_loop so a
        slow handler never stalls the socket (protocols/reading.rs)."""
        try:
            while True:
                payload = await codec.read_frame(conn.reader, self.config.max_frame_size)
                st = self.stats.get(conn.addr)
                if st:
                    st.recv_msgs += 1
                    st.recv_bytes += len(payload) + 4
                    st.last_seen = time.time()
                try:
                    conn.recv_queue.put_nowait(payload)
                except asyncio.QueueFull:
                    # reference Reading drops on a full inbound queue
                    if st:
                        st.dropped_msgs += 1
                    log.warning("%s: inbound queue full for %s, dropping",
                                self.name, conn.addr)
        except asyncio.CancelledError:
            pass
        except Exception as exc:
            kind = classify_io_error(exc)
            if kind != "benign":
                self._bump_failure(conn.addr)
                log.debug("%s: %s read error from %s: %s",
                          self.name, kind, conn.addr, exc)
        finally:
            if conn.addr in self.connections:
                asyncio.ensure_future(self.disconnect(conn.addr))

    async def _process_loop(self, conn: Connection) -> None:
        try:
            while True:
                payload = await conn.recv_queue.get()
                if self.process_message is not None:
                    await self.process_message(conn.addr, payload)
        except asyncio.CancelledError:
            pass
        except Exception as exc:
            log.debug("%s: handler error from %s: %s", self.name, conn.addr, exc)
            if conn.addr in self.connections:
                asyncio.ensure_future(self.disconnect(conn.addr))

    async def _write_loop(self, conn: Connection) -> None:
        try:
            while True:
                payload = await conn.send_queue.get()
                codec.write_frame(conn.writer, payload, self.config.max_frame_size)
                await conn.writer.drain()
                st = self.stats.get(conn.addr)
                if st:
                    st.sent_msgs += 1
                    st.sent_bytes += len(payload) + 4
        except asyncio.CancelledError:
            pass
        except Exception as exc:
            kind = classify_io_error(exc)
            if kind != "benign":
                self._bump_failure(conn.addr)
            if conn.addr in self.connections:
                asyncio.ensure_future(self.disconnect(conn.addr))

    def _bump_failure(self, addr):
        self.stats.setdefault(addr, PeerStats()).failures += 1
