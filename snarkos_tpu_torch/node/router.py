"""Router: the public P2P overlay plane (node/router semantics).

Reproduces SURVEY.md §2.3: peer tables (connected/candidate/restricted/
trusted), signed challenge-response handshake with genesis check, inbound
dispatch with rate limits and dedup caches, outbound propagation helpers,
and the heartbeat (stale eviction, churn, min/max peer maintenance,
bootstrap reconnection).

The port of ``snarkos_tpu/node/router.py``: every message it sends is the
JAX router's bytes (``messages``), its handshake the same exchange.
``handlers`` is keyed by message type and filled by the node role. It
holds no tensor: what reaches a ledger goes through the role's service.
"""

from __future__ import annotations

import asyncio
import ipaddress
import logging
import random
import secrets
import time
from collections import defaultdict, deque
from typing import Callable, Optional

from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import codec, messages as msg
from snarkos_tpu_torch.node.tcp import Tcp, TcpConfig
from snarkos_tpu_torch.node.types import address_to_point

log = logging.getLogger(__name__)

# lib.rs:105-113 equivalents
MAXIMUM_CANDIDATE_PEERS = 10_000
MAXIMUM_CONNECTION_FAILURES = 5
RADIO_SILENCE_S = 150.0
HEARTBEAT_S = 25.0
MINIMUM_NUMBER_OF_PEERS = 3
MAXIMUM_NUMBER_OF_PEERS = 21
MAX_VALIDATOR_PEERS = 200
# inbound.rs:48: nodes more than this many blocks behind skip tx/solution
# gossip (they can't validate against a stale ledger).
SYNC_LENIENCY = 10


def is_bogon_ip(ip: str) -> bool:
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return True
    return addr.is_unspecified or addr.is_multicast or addr.is_reserved


class Peer:
    def __init__(self, listening_addr, node_type: int, version: int, address: str):
        self.listening_addr = listening_addr
        self.node_type = node_type
        self.version = version
        self.address = address
        self.first_seen = time.time()
        self.last_seen = time.time()
        self.block_locators: Optional[msg.BlockLocators] = None


class RateCache:
    """Time-bucketed counters + seen-hash dedup (helpers/cache.rs)."""

    def __init__(self, interval_s: float = 5.0):
        self.interval = interval_s
        self.counters: dict = defaultdict(deque)
        self.seen: dict = {}

    def hit(self, key) -> int:
        """Record an occurrence; return the count within the interval."""
        q = self.counters[key]
        now = time.time()
        q.append(now)
        while q and q[0] < now - self.interval:
            q.popleft()
        return len(q)

    def seen_recently(self, key, ttl: float = 30.0) -> bool:
        now = time.time()
        if len(self.seen) > 1 << 17:
            self.seen.clear()
        prev = self.seen.get(key)
        self.seen[key] = now
        return prev is not None and now - prev < ttl


class Router:
    """The public plane (default port 4130)."""

    def __init__(self, account, node_type: int, genesis_hash: bytes,
                 ip: str = "127.0.0.1", port: int = 0,
                 trusted_peers: tuple = (), max_peers: int = MAXIMUM_NUMBER_OF_PEERS,
                 allow_external_peers: bool = True):
        self.account = account
        self.node_type = node_type
        self.genesis_hash = genesis_hash
        self.trusted_peers = [tuple(p) for p in trusted_peers]
        self.max_peers = max_peers
        self.allow_external_peers = allow_external_peers
        self.tcp = Tcp(
            TcpConfig(listener_ip=ip, desired_listening_port=port,
                      max_connections=max(max_peers * 2, 40),
                      max_frame_size=codec.MAX_FRAME_ROUTER),
            name="router",
        )
        self.tcp.handshake = self._handshake
        self.tcp.process_message = self._inbound
        self.tcp.on_disconnect = self._on_disconnect
        self.peers: dict[tuple, Peer] = {}  # socket addr -> Peer
        self.candidate_peers: set = set()
        self.restricted_peers: dict[tuple, float] = {}
        # ip -> recent attempt timestamps, pruned to the radio-silence
        # window (handshake.rs:304-314 time-bucketed cache: a legitimate
        # peer reconnecting over a node's lifetime must NOT accumulate
        # attempts forever)
        self.connection_attempts: dict[str, list] = defaultdict(list)
        # network-wide restrictions list commitment, exchanged and verified
        # in the handshake (handshake.rs:341-354; zero in dev networks)
        self.restrictions_id: bytes = b"\x00" * 32
        self.cache = RateCache()
        self.sent_cache = RateCache()
        # role hook: returns our latest block height (None -> always synced).
        # Used for the SYNC_LENIENCY gossip gate (inbound.rs:48,237,267).
        self.latest_height_fn: Optional[Callable[[], int]] = None
        # handler hooks (wired by the node role)
        self.handlers: dict[type, Callable] = {}
        self._tasks: list[asyncio.Task] = []
        self._running = False

    # -- queries -------------------------------------------------------------
    @property
    def address(self) -> str:
        return self.account.address

    @property
    def local_addr(self):
        return self.tcp.listening_addr

    def connected_peers(self) -> list[tuple]:
        return list(self.peers)

    def connected_validators(self) -> list[tuple]:
        return [a for a, p in self.peers.items() if p.node_type == msg.NodeType.VALIDATOR]

    def number_of_connected_peers(self) -> int:
        return len(self.peers)

    def num_blocks_behind(self) -> int:
        """How far our chain tip trails the tallest peer's locators."""
        if self.latest_height_fn is None:
            return 0
        ours = self.latest_height_fn()
        tallest = max(
            (p.block_locators.latest_height for p in self.peers.values()
             if p.block_locators is not None),
            default=0,
        )
        return max(0, tallest - ours)

    def is_within_sync_leniency(self) -> bool:
        return self.num_blocks_behind() <= SYNC_LENIENCY

    # -- handshake (handshake.rs:84-371) -------------------------------------
    async def _handshake(self, conn) -> None:
        if conn.side == "responder":
            ip = conn.addr[0]
            # time-bucketed attempt counting (loopback exempt, as in the
            # reference — handshake.rs:305)
            if ip not in ("127.0.0.1", "::1"):
                now = time.time()
                attempts = self.connection_attempts[ip]
                attempts[:] = [t for t in attempts if now - t < RADIO_SILENCE_S]
                attempts.append(now)
                if len(attempts) > MAXIMUM_CONNECTION_FAILURES:
                    self.restricted_peers[conn.addr] = now
                    raise ConnectionError("too many connection attempts; restricted")
            if not self.allow_external_peers and conn.addr not in self.trusted_peers:
                raise ConnectionError("external peers are not allowed")

        my_nonce = secrets.randbits(64)
        reader, writer = conn.reader, conn.writer

        async def send(m):
            codec.write_frame(writer, msg.serialize(m), codec.MAX_FRAME_HANDSHAKE)
            await writer.drain()

        async def recv():
            return msg.deserialize(await codec.read_frame(reader, codec.MAX_FRAME_HANDSHAKE))

        my_req = msg.ChallengeRequest(
            msg.VERSION, self.local_addr[1], self.node_type, self.address, my_nonce
        )
        if conn.side == "initiator":
            await send(my_req)
            peer_req = await recv()
            self._check_challenge_request(peer_req)
            await send(self._challenge_response(peer_req.nonce, my_nonce))
            peer_resp = await recv()
            self._check_challenge_response(peer_req.address, my_nonce, peer_resp, peer_req.node_type)
        else:
            peer_req = await recv()
            self._check_challenge_request(peer_req)
            await send(my_req)
            peer_resp = await recv()
            self._check_challenge_response(peer_req.address, my_nonce, peer_resp, peer_req.node_type)
            await send(self._challenge_response(peer_req.nonce, my_nonce))

        listening = (conn.addr[0], peer_req.listener_port)
        self.peers[conn.addr] = Peer(
            listening, peer_req.node_type, peer_req.version, peer_req.address
        )
        self.candidate_peers.discard(listening)

    def _challenge_response(self, peer_nonce: int, my_nonce: int) -> msg.ChallengeResponse:
        sig = edwards.sign_bytes(
            self.account.sk, self.account.pk,
            peer_nonce.to_bytes(8, "little") + my_nonce.to_bytes(8, "little"),
        )
        return msg.ChallengeResponse(self.genesis_hash, self.restrictions_id, sig, my_nonce)

    def _check_challenge_request(self, req):
        if not isinstance(req, msg.ChallengeRequest):
            raise ConnectionError("expected challenge request")
        if req.version < msg.VERSION:
            raise ConnectionError("outdated protocol version")

    def _check_challenge_response(self, peer_address: str, my_nonce: int, resp,
                                  peer_node_type: int | None = None):
        if not isinstance(resp, msg.ChallengeResponse):
            raise ConnectionError("expected challenge response")
        if resp.genesis_hash != self.genesis_hash:
            raise ConnectionError("genesis mismatch")
        # restrictions commitment must match unless either side is a prover
        # (handshake.rs:341-354)
        prover_involved = (peer_node_type == msg.NodeType.PROVER
                           or self.node_type == msg.NodeType.PROVER)
        if not prover_involved and resp.restrictions_id != self.restrictions_id:
            raise ConnectionError("restrictions id mismatch")
        pk = address_to_point(peer_address)
        payload = my_nonce.to_bytes(8, "little") + resp.nonce.to_bytes(8, "little")
        if not edwards.verify_bytes(pk, payload, resp.signature):
            raise ConnectionError("invalid handshake signature")

    async def _on_disconnect(self, addr):
        peer = self.peers.pop(addr, None)
        if peer is not None and not is_bogon_ip(peer.listening_addr[0]):
            if len(self.candidate_peers) < MAXIMUM_CANDIDATE_PEERS:
                self.candidate_peers.add(peer.listening_addr)

    # -- inbound (inbound.rs:57-295) -----------------------------------------
    async def _inbound(self, addr, payload: bytes) -> None:
        peer = self.peers.get(addr)
        if peer is None:
            return
        # global per-peer rate limit: >= 500 msgs / 5 s -> drop connection
        if self.cache.hit(("msgs", addr)) >= 500:
            log.warning("router: rate limit exceeded by %s", addr)
            await self.tcp.disconnect(addr)
            return
        try:
            m = msg.deserialize(payload)
        except Exception as exc:
            log.debug("router: malformed message from %s: %s", addr, exc)
            await self.tcp.disconnect(addr)
            return
        peer.last_seen = time.time()

        async def run_handler():
            try:
                await self._dispatch(addr, peer, m)
            except Exception as exc:
                log.debug("router: handler error for %s: %s", msg.message_name(m), exc)

        asyncio.create_task(run_handler())

    async def _dispatch(self, addr, peer: Peer, m) -> None:
        if isinstance(m, msg.Ping):
            if m.locators is not None:
                if not m.locators.is_well_formed():
                    await self.tcp.disconnect(addr)
                    return
                peer.block_locators = m.locators
            peer.node_type = m.node_type
            self.tcp.unicast(addr, msg.serialize(msg.Pong(None)))
            return
        if isinstance(m, msg.Pong):
            return
        if isinstance(m, msg.PeerRequest):
            peers = [p.listening_addr for a, p in self.peers.items() if a != addr][:10]
            self.tcp.unicast(addr, msg.serialize(msg.PeerResponse(tuple(peers))))
            return
        if isinstance(m, msg.PeerResponse):
            for entry in m.peers:
                entry = (entry[0], int(entry[1]))
                if not is_bogon_ip(entry[0]) and not self.tcp.is_self(entry):
                    if len(self.candidate_peers) < MAXIMUM_CANDIDATE_PEERS:
                        self.candidate_peers.add(entry)
            return
        if isinstance(m, msg.BlockRequest):
            # bounds: <= 5 blocks per request, <= 256 requests per interval
            if m.end_height <= m.start_height or m.end_height - m.start_height > msg.DATA_BLOCKS_MAX:
                await self.tcp.disconnect(addr)
                return
            if self.cache.hit(("block_req", addr)) > 256:
                await self.tcp.disconnect(addr)
                return
        if isinstance(m, msg.PuzzleRequest):
            if self.cache.hit(("puzzle_req", addr)) > 5:
                await self.tcp.disconnect(addr)
                return
        if isinstance(m, (msg.UnconfirmedSolution, msg.UnconfirmedTransaction)):
            # syncing nodes skip tx/solution gossip entirely (inbound.rs:237,267)
            if not self.is_within_sync_leniency():
                return
            key = ("seen", m.solution_id if isinstance(m, msg.UnconfirmedSolution)
                   else m.transaction_id)
            if self.cache.seen_recently(key):
                return  # dedup without penalty
        handler = self.handlers.get(type(m))
        if handler is not None:
            await handler(addr, peer, m)

    # -- outbound (outbound.rs:28-168) ---------------------------------------
    def send(self, addr: tuple, m) -> bool:
        return self.tcp.unicast(addr, msg.serialize(m))

    def propagate(self, m, exclude: set | None = None) -> int:
        """Broadcast, skipping peers we already sent this item to."""
        key = None
        if isinstance(m, msg.UnconfirmedSolution):
            key = m.solution_id
        elif isinstance(m, msg.UnconfirmedTransaction):
            key = m.transaction_id
        payload = msg.serialize(m)
        count = 0
        for addr in list(self.peers):
            if exclude and addr in exclude:
                continue
            if key is not None and self.sent_cache.seen_recently((addr, key)):
                continue
            if self.tcp.unicast(addr, payload):
                count += 1
        return count

    def propagate_to_validators(self, m, exclude: set | None = None) -> int:
        payload = msg.serialize(m)
        count = 0
        for addr in self.connected_validators():
            if exclude and addr in exclude:
                continue
            if self.tcp.unicast(addr, payload):
                count += 1
        return count

    # -- lifecycle & heartbeat (heartbeat.rs:35-301) -------------------------
    async def run(self) -> tuple:
        listen = await self.tcp.enable_listener()
        self._running = True
        self._tasks.append(asyncio.create_task(self._heartbeat_loop()))
        return listen

    async def shut_down(self):
        self._running = False
        for t in self._tasks:
            t.cancel()
        await self.tcp.shut_down()

    async def connect(self, addr: tuple) -> bool:
        addr = (addr[0], int(addr[1]))
        if addr in self.restricted_peers or self.tcp.is_self(addr):
            return False
        try:
            await self.tcp.connect(addr)
            return True
        except Exception as exc:
            log.debug("router: connect to %s failed: %s", addr, exc)
            self.candidate_peers.discard(addr)
            return False

    async def _heartbeat_loop(self):
        while self._running:
            try:
                await asyncio.sleep(HEARTBEAT_S)
                await self._heartbeat()
            except asyncio.CancelledError:
                return
            except Exception as exc:
                log.debug("router heartbeat error: %s", exc)

    async def _heartbeat(self):
        now = time.time()
        # 1. remove stale peers (radio silence)
        for addr in [a for a, p in self.peers.items() if now - p.last_seen > RADIO_SILENCE_S]:
            await self.tcp.disconnect(addr)
        # 2. unrestrict old offenders
        for addr in [a for a, t in self.restricted_peers.items() if now - t > 600]:
            del self.restricted_peers[addr]
        # 3. enforce bounds / top up
        # 3a. cap provers at max/4 (heartbeat.rs: max_provers), oldest first
        max_provers = max(1, self.max_peers // 4)
        provers = sorted(
            (a for a, p in self.peers.items() if p.node_type == msg.NodeType.PROVER),
            key=lambda a: self.peers[a].first_seen,
        )
        for addr in provers[: max(0, len(provers) - max_provers)]:
            await self.tcp.disconnect(addr)
        n = len(self.peers)
        if n > self.max_peers:
            extra = [a for a, p in self.peers.items()
                     if p.listening_addr not in self.trusted_peers]
            for addr in random.sample(extra, min(len(extra), n - self.max_peers)):
                await self.tcp.disconnect(addr)
        elif n == self.max_peers and self.candidate_peers:
            # churn: rotate the longest-connected untrusted peer so the
            # overlay keeps mixing (heartbeat.rs "remove oldest" rotation)
            untrusted = [a for a, p in self.peers.items()
                         if p.listening_addr not in self.trusted_peers]
            if untrusted:
                oldest = min(untrusted, key=lambda a: self.peers[a].first_seen)
                await self.tcp.disconnect(oldest)
        elif n < MINIMUM_NUMBER_OF_PEERS or n < self.max_peers // 2:
            candidates = list(self.candidate_peers)[:8]
            for addr in candidates:
                self.candidate_peers.discard(addr)
                asyncio.create_task(self.connect(addr))
        # 4. reconnect trusted peers
        connected_listeners = {p.listening_addr for p in self.peers.values()}
        for addr in self.trusted_peers:
            if tuple(addr) not in connected_listeners:
                asyncio.create_task(self.connect(tuple(addr)))
        # 5. gossip a peer request
        if self.peers:
            target = random.choice(list(self.peers))
            self.send(target, msg.PeerRequest())
        # 6. send pings with locators (wired by the node role via handler)
        ping_builder = self.handlers.get("ping_builder")
        if ping_builder is not None:
            ping = ping_builder()
            for addr in list(self.peers):
                self.send(addr, ping)
