"""Gateway: the validator-only BFT transport plane (node/bft/src/gateway.rs).

Semantics reproduced (SURVEY.md §2.5 Gateway): TCP listener on the
memory-pool port, signed challenge-response handshake where BOTH sides
must be authorized committee members, event dispatch to primary/worker/
sync handlers, validator discovery (ValidatorsRequest/Response), and a
heartbeat that reconnects trusted validators and tops up connectivity.
Implements the Transport seam (``send``/``broadcast``) the primary uses,
and the CommunicationService seam block sync uses.

The port of ``snarkos_tpu/node/gateway.py``: its events are the JAX
gateway's bytes (``events``), its ``send(peer, event)`` / ``broadcast(event)``
the transport that ``bft/primary.py`` takes. It holds no tensor; the
committee checks ask the ledger service it is given.
"""

from __future__ import annotations

import asyncio
import logging
import random
import secrets
from typing import Callable, Optional

from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import codec, events as ev
from snarkos_tpu_torch.node.router import RateCache
from snarkos_tpu_torch.node.tcp import Tcp, TcpConfig
from snarkos_tpu_torch.node.types import Committee, address_to_point

log = logging.getLogger(__name__)

MEMORY_POOL_PORT = 5000
MIN_CONNECTED_VALIDATORS = 175
MAX_VALIDATORS_TO_SEND = 200
# dynamic rate limits scaled to committee size (gateway.rs:208-236):
# per-peer budgets within one 5 s cache interval; spam -> disconnect
CACHE_EVENTS_PER_PEER = 500
CACHE_REQUESTS_PER_COMMITTEE_MEMBER = 10


class Gateway:
    def __init__(self, account, ledger, ip: str = "127.0.0.1", port: int = 0,
                 trusted_validators: tuple = ()):
        self.account = account
        self.ledger = ledger
        self.trusted_validators = list(trusted_validators)  # [(ip, port)]
        self.tcp = Tcp(
            TcpConfig(
                listener_ip=ip,
                desired_listening_port=port,
                max_connections=Committee.MAX_COMMITTEE_SIZE,
                max_frame_size=codec.MAX_FRAME_GATEWAY,
            ),
            name="gateway",
        )
        self.tcp.handshake = self._handshake
        self.tcp.process_message = self._inbound
        self.tcp.on_disconnect = self._on_disconnect
        # addr (ip,port of socket) -> validator address; and reverse
        self.connected_validators: dict[tuple, str] = {}
        self.resolver: dict[str, tuple] = {}
        self.listener_addrs: dict[tuple, tuple] = {}  # socket addr -> listener addr
        self.conn_initiator: dict[tuple, str] = {}  # socket addr -> initiator's validator address
        self.rate_cache = RateCache(interval_s=5.0)
        # handler hooks (wired by Validator/Consensus)
        self.on_batch_propose: Optional[Callable] = None
        self.on_batch_signature: Optional[Callable] = None
        self.on_batch_certified: Optional[Callable] = None
        self.on_certificate_request: Optional[Callable] = None
        self.on_certificate_response: Optional[Callable] = None
        self.on_transmission_request: Optional[Callable] = None
        self.on_transmission_response: Optional[Callable] = None
        self.on_worker_ping: Optional[Callable] = None
        self.on_block_request: Optional[Callable] = None
        self.on_block_response: Optional[Callable] = None
        self.on_primary_ping: Optional[Callable] = None
        self._tasks: list[asyncio.Task] = []
        self._running = False

    @property
    def address(self) -> str:
        return self.account.address

    @property
    def local_addr(self):
        return self.tcp.listening_addr

    # -- authorization (gateway.rs:328-376) ----------------------------------
    def is_authorized(self, validator_address: str) -> bool:
        round_ = max(1, self.ledger.latest_round())
        for r in (round_, round_ + 1, max(1, round_ - 1)):
            if self.ledger.committee_lookback_for(r).is_member(validator_address):
                return True
        return False

    # -- handshake (signed challenge/response, both sides authorized) --------
    async def _handshake(self, conn) -> None:
        my_nonce = secrets.randbits(64)
        reader, writer = conn.reader, conn.writer

        async def send_event(event):
            codec.write_frame(writer, ev.serialize(event), codec.MAX_FRAME_HANDSHAKE)
            await writer.drain()

        async def recv_event():
            return ev.deserialize(await codec.read_frame(reader, codec.MAX_FRAME_HANDSHAKE))

        if conn.side == "initiator":
            await send_event(ev.GatewayChallengeRequest(
                ev.VERSION, self.local_addr[1], self.address, my_nonce))
            peer_req = await recv_event()
            if not isinstance(peer_req, ev.GatewayChallengeRequest):
                raise ConnectionError("expected challenge request")
            self._check_peer_request(peer_req)
            sig = edwards.sign_bytes(
                self.account.sk, self.account.pk,
                peer_req.nonce.to_bytes(8, "little") + my_nonce.to_bytes(8, "little"),
            )
            await send_event(ev.GatewayChallengeResponse(sig, my_nonce))
            peer_resp = await recv_event()
            if not isinstance(peer_resp, ev.GatewayChallengeResponse):
                raise ConnectionError("expected challenge response")
            self._verify_response(peer_req.address, my_nonce, peer_resp)
        else:
            peer_req = await recv_event()
            if not isinstance(peer_req, ev.GatewayChallengeRequest):
                raise ConnectionError("expected challenge request")
            self._check_peer_request(peer_req)
            await send_event(ev.GatewayChallengeRequest(
                ev.VERSION, self.local_addr[1], self.address, my_nonce))
            peer_resp = await recv_event()
            if not isinstance(peer_resp, ev.GatewayChallengeResponse):
                raise ConnectionError("expected challenge response")
            self._verify_response(peer_req.address, my_nonce, peer_resp)
            sig = edwards.sign_bytes(
                self.account.sk, self.account.pk,
                peer_req.nonce.to_bytes(8, "little") + my_nonce.to_bytes(8, "little"),
            )
            await send_event(ev.GatewayChallengeResponse(sig, my_nonce))

        if peer_req.address == self.address:
            raise ConnectionError("self-connect")
        # one-connection-per-validator invariant with a deterministic
        # tie-break for simultaneous dials: keep the connection whose
        # INITIATOR has the smaller validator address (both ends compute
        # the same answer, so exactly one of the two connections survives)
        new_initiator = self.address if conn.side == "initiator" else peer_req.address
        existing = self.resolver.get(peer_req.address)
        if existing is not None:
            old_initiator = self.conn_initiator.get(existing, "")
            if new_initiator < old_initiator:
                asyncio.ensure_future(self.tcp.disconnect(existing))
            else:
                raise ConnectionError("duplicate connection")
        self.conn_initiator[conn.addr] = new_initiator
        self.connected_validators[conn.addr] = peer_req.address
        self.resolver[peer_req.address] = conn.addr
        self.listener_addrs[conn.addr] = (conn.addr[0], peer_req.listener_port)

    def _check_peer_request(self, req: ev.GatewayChallengeRequest):
        if req.version < ev.VERSION:
            raise ConnectionError("outdated protocol version")
        if not self.is_authorized(req.address):
            raise ConnectionError(f"unauthorized validator {req.address[:16]}")

    def _verify_response(self, peer_address: str, my_nonce: int,
                         resp: ev.GatewayChallengeResponse):
        pk = address_to_point(peer_address)
        msg = my_nonce.to_bytes(8, "little") + resp.nonce.to_bytes(8, "little")
        if not edwards.verify_bytes(pk, msg, resp.signature):
            raise ConnectionError("invalid handshake signature")

    async def _on_disconnect(self, addr):
        va = self.connected_validators.pop(addr, None)
        self.listener_addrs.pop(addr, None)
        self.conn_initiator.pop(addr, None)
        # the resolver may already point at a NEWER connection to the same
        # validator (duplicate tie-break) — only drop our own mapping
        if va is not None and self.resolver.get(va) == addr:
            self.resolver.pop(va, None)

    # -- Transport seam (gateway.rs:95-98,979-1037) --------------------------
    def send(self, peer, event) -> bool:
        """peer: socket addr tuple OR validator address string."""
        addr = self.resolver.get(peer, peer) if isinstance(peer, str) else peer
        if not isinstance(addr, tuple):
            return False
        return self.tcp.unicast(addr, ev.serialize(event))

    def broadcast(self, event) -> int:
        return self.tcp.broadcast(ev.serialize(event))

    # -- inbound dispatch (gateway.rs:535-832) -------------------------------
    async def _inbound(self, addr, payload: bytes) -> None:
        validator = self.connected_validators.get(addr)
        if validator is None:
            return
        if self.rate_cache.hit(("events", addr)) > CACHE_EVENTS_PER_PEER:
            log.warning("gateway: %s exceeded the event rate limit; disconnecting",
                        validator[:16])
            await self.tcp.disconnect(addr)
            return
        try:
            event = ev.deserialize(payload)
        except Exception as exc:
            log.debug("gateway: malformed event from %s: %s", addr, exc)
            await self.tcp.disconnect(addr)
            return
        # request-type budgets scale with committee size (gateway.rs:544-548)
        if isinstance(event, (ev.CertificateRequest, ev.TransmissionRequest,
                              ev.BlockRequest, ev.ValidatorsRequest)):
            budget = CACHE_REQUESTS_PER_COMMITTEE_MEMBER * max(
                4, len(self.ledger.current_committee().members)
            )
            if self.rate_cache.hit(("requests", addr)) > budget:
                log.warning("gateway: %s exceeded the request rate limit; "
                            "disconnecting", validator[:16])
                await self.tcp.disconnect(addr)
                return
        # dispatch concurrently: a handler may await responses that arrive
        # on this same connection (the read loop must keep draining)
        async def run_handler():
            try:
                await self._dispatch(addr, validator, event)
            except Exception as exc:
                log.debug("gateway: handler error for %s from %s: %s",
                          ev.event_name(event), validator[:16], exc)

        asyncio.create_task(run_handler())

    async def _dispatch(self, addr, validator, event) -> None:
        if isinstance(event, ev.BatchPropose) and self.on_batch_propose:
            await self.on_batch_propose(addr, event)
        elif isinstance(event, ev.BatchSignature) and self.on_batch_signature:
            await self.on_batch_signature(addr, event, validator)
        elif isinstance(event, ev.BatchCertified) and self.on_batch_certified:
            await self.on_batch_certified(addr, event)
        elif isinstance(event, ev.CertificateRequest) and self.on_certificate_request:
            self.on_certificate_request(addr, event)
        elif isinstance(event, ev.CertificateResponse) and self.on_certificate_response:
            await self.on_certificate_response(addr, event)
        elif isinstance(event, ev.TransmissionRequest) and self.on_transmission_request:
            self.on_transmission_request(addr, event)
        elif isinstance(event, ev.TransmissionResponse) and self.on_transmission_response:
            self.on_transmission_response(event)
        elif isinstance(event, ev.WorkerPing) and self.on_worker_ping:
            self.on_worker_ping(addr, event)
        elif isinstance(event, ev.BlockRequest) and self.on_block_request:
            await self.on_block_request(addr, event)
        elif isinstance(event, ev.BlockResponse) and self.on_block_response:
            await self.on_block_response(addr, event)
        elif isinstance(event, ev.PrimaryPing) and self.on_primary_ping:
            await self.on_primary_ping(addr, event)
        elif isinstance(event, ev.ValidatorsRequest):
            entries = []
            for a, va in list(self.connected_validators.items())[:MAX_VALIDATORS_TO_SEND]:
                listener = self.listener_addrs.get(a, a)
                entries.append((listener[0], listener[1], va))
            self.send(addr, ev.ValidatorsResponse(tuple(entries)))
        elif isinstance(event, ev.ValidatorsResponse):
            for ip, port, va in event.validators:
                if va != self.address and va not in self.resolver and self.is_authorized(va):
                    asyncio.create_task(self._try_connect((ip, port)))
        elif isinstance(event, ev.Disconnect):
            await self.tcp.disconnect(addr)

    # -- lifecycle -----------------------------------------------------------
    async def run(self) -> tuple:
        listen = await self.tcp.enable_listener()
        self._running = True
        self._tasks.append(asyncio.create_task(self._heartbeat()))
        return listen

    async def shut_down(self):
        self._running = False
        for t in self._tasks:
            t.cancel()
        await self.tcp.shut_down()

    async def connect_to(self, addr: tuple) -> None:
        await self._try_connect(addr)

    async def _try_connect(self, addr):
        try:
            await self.tcp.connect(addr)
        except Exception as exc:
            log.debug("gateway: connect to %s failed: %s", addr, exc)

    async def _heartbeat(self):
        """gateway.rs:880-977: reconnect trusted validators; top up
        connectivity with ValidatorsRequest."""
        while self._running:
            try:
                await asyncio.sleep(5.0)
                connected = set(self.listener_addrs.values())
                for addr in self.trusted_validators:
                    if tuple(addr) not in connected and not self.tcp.is_self(tuple(addr)):
                        await self._try_connect(tuple(addr))
                if 0 < len(self.connected_validators) < MIN_CONNECTED_VALIDATORS:
                    target = random.choice(list(self.connected_validators.keys()))
                    self.send(target, ev.ValidatorsRequest())
            except asyncio.CancelledError:
                return
            except Exception as exc:
                log.debug("gateway heartbeat error: %s", exc)
