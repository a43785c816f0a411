"""Narwhal primary + worker (node/bft/src/primary.rs, worker.rs semantics).

The primary drives the batch lifecycle (SURVEY.md §3.2):
propose_batch -> peers sign (BatchSignature) -> certificate -> broadcast
BatchCertified -> DAG insert -> round advance. The worker is the mempool
shard: it validates incoming transmissions against the ledger ([HOT]
check_solution_basic / check_transaction_basic) and holds the ready queue
drained at proposal time.

Transport is abstracted (``send(address, event)`` / ``broadcast(event)``)
so tests run primaries over an in-process mock gateway, mirroring the
reference's Transport/CommunicationService seams (§4 item 2).

The port of ``snarkos_tpu/node/bft/primary.py``: the same timers, rules and
wire events. The ledger service the caller passes in does the checks, on
its own device (``CoreLedgerService`` over a ``Ledger`` on the card runs the
solutions' bindings and every KZG batch there); the mempool partition's
sha256d is ``hashlib``'s. One rule differs: a device fault in a proposal's
re-checks is handed to ``on_fault`` and ends the proposer loop, where the
reference skips the transmission.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import events as ev
from snarkos_tpu_torch.node.bft.storage import NarwhalStorage
from snarkos_tpu_torch.node.types import (
    BatchCertificate,
    BatchHeader,
    Committee,
    Solution,
    Transaction,
    Transmission,
    TransmissionID,
    address_to_point,
)

log = logging.getLogger(__name__)

# protocol constants (node/bft/src/lib.rs:46-68 equivalents)
MAX_BATCH_DELAY_S = 2.5
MIN_BATCH_DELAY_S = 1.0
MAX_FETCH_TIMEOUT_S = 7.5
MAX_LEADER_CERTIFICATE_DELAY_S = 5.0
MAX_TIMESTAMP_DELTA_S = 10
PRIMARY_PING_S = 5.0
WORKER_PING_S = 10.0
MAX_WORKERS = 1
MAX_TRANSMISSIONS_PER_BATCH = BatchHeader.MAX_TRANSMISSIONS_PER_BATCH


def assign_to_worker(tid: TransmissionID, num_workers: int) -> int:
    """sha256d-based mempool partition (helpers/partition.rs:32-67): the
    low 128 bits of sha256d(tid bytes) mod the worker count."""
    if num_workers == 1:
        return 0
    h = hashlib.sha256(hashlib.sha256(tid.to_bytes()).digest()).digest()
    return int.from_bytes(h[:16], "little") % num_workers


@dataclass
class Proposal:
    """An in-flight batch proposal accumulating peer signatures
    (helpers/proposal.rs:33-165)."""

    batch_header: BatchHeader
    transmissions: dict  # TransmissionID -> Transmission
    signatures: dict = field(default_factory=dict)  # address -> sig

    @property
    def round(self) -> int:
        return self.batch_header.round

    @property
    def batch_id(self) -> bytes:
        return self.batch_header.batch_id

    def add_signature(self, signer: str, sig, committee: Committee) -> None:
        if not committee.is_member(signer):
            raise ValueError("signer is not in the committee")
        if signer == self.batch_header.author:
            raise ValueError("author cannot endorse own batch")
        pk = address_to_point(signer)
        if not edwards.verify_bytes(pk, self.batch_id, sig):
            raise ValueError("invalid batch signature")
        self.signatures[signer] = sig

    def is_quorum(self, committee: Committee) -> bool:
        return committee.is_quorum([self.batch_header.author, *self.signatures])

    def to_certificate(self) -> BatchCertificate:
        return BatchCertificate(
            batch_header=self.batch_header,
            signatures=tuple(sorted(self.signatures.items())),
        )


class Worker:
    """Mempool shard (worker.rs:43-60). One per primary (MAX_WORKERS=1)."""

    def __init__(self, wid: int, ledger, storage: NarwhalStorage, transport):
        self.id = wid
        self.ledger = ledger
        self.storage = storage
        self.transport = transport
        self.ready: dict[TransmissionID, Transmission] = {}  # ordered
        self.pending: dict[TransmissionID, list] = {}  # tid -> waiters
        self.pending_expiry: dict[TransmissionID, float] = {}
        self.pending_requests: dict[TransmissionID, set] = {}  # tid -> peers asked
        # extra lookup (e.g. the primary's in-flight proposal transmissions)
        self.extra_lookup = None

    # -- ingestion (worker.rs:321-382) --------------------------------------
    async def process_unconfirmed_solution(self, sol: Solution) -> None:
        tid = sol.id
        if self._already_known(tid):
            return
        await asyncio.get_event_loop().run_in_executor(
            None, self.ledger.check_solution_basic, sol
        )
        self.ready[tid] = Transmission.from_solution(sol)

    async def process_unconfirmed_transaction(self, tx: Transaction) -> None:
        tid = tx.id
        if self._already_known(tid):
            return
        await asyncio.get_event_loop().run_in_executor(
            None, self.ledger.check_transaction_basic, tx
        )
        self.ready[tid] = Transmission.from_transaction(tx)

    def _already_known(self, tid: TransmissionID) -> bool:
        return (
            tid in self.ready
            or self.storage.contains_transmission(tid)
            or self.ledger.contains_transmission(tid)
        )

    # -- peer pull (worker.rs:437-509) --------------------------------------
    def max_redundant_requests(self) -> int:
        """pending.rs:35-47: fetch from at most 1 + N/3 distinct peers."""
        try:
            n = len(self.ledger.current_committee().members)
        except Exception:
            n = 1
        return 1 + n // 3

    def process_worker_ping(self, peer_addr, ping: ev.WorkerPing) -> None:
        limit = MAX_TRANSMISSIONS_PER_BATCH // 10
        cap = self.max_redundant_requests()
        for tid in ping.transmission_ids[:limit]:
            if self._already_known(tid):
                continue
            asked = self.pending_requests.setdefault(tid, set())
            # expired fetch: allow a fresh round of redundant requests
            if self.pending_expiry.get(tid, float("inf")) < time.time():
                asked.clear()
            if peer_addr in asked or len(asked) >= cap:
                continue
            asked.add(peer_addr)
            self.pending.setdefault(tid, [])
            self.pending_expiry[tid] = time.time() + MAX_FETCH_TIMEOUT_S
            self.transport.send(peer_addr, ev.TransmissionRequest(tid))

    def process_transmission_response(self, resp: ev.TransmissionResponse) -> None:
        tid = resp.transmission_id
        waiters = self.pending.pop(tid, None)
        self.pending_expiry.pop(tid, None)
        self.pending_requests.pop(tid, None)
        if resp.transmission is None:
            if waiters:
                for fut in waiters:
                    if not fut.done():
                        fut.set_exception(ValueError("peer lacks transmission"))
            return
        from snarkos_tpu_torch.node.codec import Reader

        t = Transmission.from_reader(Reader(resp.transmission))
        if t.id != tid:
            log.warning("worker %d: transmission id mismatch from peer", self.id)
            return
        if not self._already_known(tid):
            self.ready[tid] = t
        if waiters:
            for fut in waiters:
                if not fut.done():
                    fut.set_result(t)

    def serve_transmission_request(self, peer_addr, req: ev.TransmissionRequest) -> None:
        t = self.ready.get(req.transmission_id) or self.storage.get_transmission(
            req.transmission_id
        )
        if t is None and self.extra_lookup is not None:
            t = self.extra_lookup(req.transmission_id)
        self.transport.send(
            peer_addr,
            ev.TransmissionResponse(req.transmission_id, t.to_bytes() if t else None),
        )

    async def fetch_transmission(self, peer_addr, tid: TransmissionID):
        """Request a missing transmission; await its arrival (pending.rs
        callback-queue equivalent)."""
        existing = self.ready.get(tid) or self.storage.get_transmission(tid)
        if existing is not None:
            return existing
        fut = asyncio.get_event_loop().create_future()
        self.pending.setdefault(tid, []).append(fut)
        self.pending_expiry[tid] = time.time() + MAX_FETCH_TIMEOUT_S
        self.transport.send(peer_addr, ev.TransmissionRequest(tid))
        return await asyncio.wait_for(fut, MAX_FETCH_TIMEOUT_S)

    def drain(self, limit: int) -> dict:
        """Take up to ``limit`` ready transmissions for a proposal."""
        out = {}
        for tid in list(self.ready)[:limit]:
            out[tid] = self.ready.pop(tid)
        return out

    def reinsert(self, transmissions: dict) -> None:
        for tid, t in transmissions.items():
            if not self._already_known(tid):
                self.ready[tid] = t

    def advertised_ids(self) -> tuple:
        return tuple(list(self.ready)[: MAX_TRANSMISSIONS_PER_BATCH // 10])


class Primary:
    """The Narwhal primary (primary.rs:82-105)."""

    def __init__(self, account, ledger, storage: NarwhalStorage, transport,
                 on_certificate: Optional[Callable] = None,
                 num_workers: int = MAX_WORKERS):
        self.account = account
        self.ledger = ledger
        self.storage = storage
        self.transport = transport
        self.workers = [Worker(i, ledger, storage, transport)
                        for i in range(max(1, num_workers))]
        for w in self.workers:
            w.extra_lookup = self._lookup_proposal_transmission
        self.worker = self.workers[0]  # single-worker fast path / compat
        self.proposed_batch: Optional[Proposal] = None
        self.signed_proposals: dict[str, tuple] = {}  # author -> (round, batch_id, sig)
        self.latest_certificate: Optional[BatchCertificate] = None
        self.propose_lock = asyncio.Lock()
        self.on_certificate = on_certificate  # BFT hook: async fn(cert)
        self.on_round_advance: Optional[Callable] = None  # async fn(round)
        # the device-fault rule (Consensus sets it): fn(exc, where) -> True
        # when ``exc`` is a device fault, which stops the node
        self.on_fault: Optional[Callable] = None
        self.last_proposal_time = 0.0
        self._tasks: list[asyncio.Task] = []
        self.running = False

    @property
    def address(self) -> str:
        return self.account.address

    def _lookup_proposal_transmission(self, tid):
        if self.proposed_batch is not None:
            return self.proposed_batch.transmissions.get(tid)
        return None

    def current_round(self) -> int:
        return self.storage.current_round()

    # -- propose (primary.rs:339-621) ---------------------------------------
    async def propose_batch(self) -> bool:
        async with self.propose_lock:
            round_ = self.storage.current_round()
            committee = self.ledger.committee_lookback_for(round_)
            if not committee.is_member(self.address):
                return False
            if self.proposed_batch is not None:
                if self.proposed_batch.round >= round_:
                    return False  # still collecting signatures
                self.reinsert_transmissions(self.proposed_batch.transmissions)
                self.proposed_batch = None
            # already certified a batch this round (waiting on the BFT to
            # advance): proposing again would be equivocation
            if self.storage.get_certificate_for_round_with_author(round_, self.address) is not None:
                return False
            # previous round certificates must reach quorum (primary.rs:463-489)
            prev_ids: tuple = ()
            if round_ > 1:
                prev_certs = self.storage.get_certificates_for_round(round_ - 1)
                authors = [c.author for c in prev_certs]
                prev_committee = self.ledger.committee_lookback_for(round_ - 1)
                if not prev_committee.is_quorum(authors):
                    return False
                prev_ids = tuple(c.id for c in prev_certs)
            transmissions = await self._drain_and_revalidate()
            timestamp = int(time.time())
            header = BatchHeader.sign_new(
                self.account, round_, timestamp, committee.id,
                list(transmissions.keys()), prev_ids,
            )
            self.proposed_batch = Proposal(batch_header=header, transmissions=transmissions)
            self.last_proposal_time = time.time()
            self.transport.broadcast(ev.BatchPropose(round_, header.to_bytes()))
            log.debug("%s proposed batch r=%d with %d transmissions",
                      self.address[:12], round_, len(transmissions))
            return True

    async def _drain_and_revalidate(self) -> dict:
        """Drain the workers, RE-validating every transmission against the
        ledger at proposal time (primary.rs:491-576): transmissions valid
        at ingest may have been committed or invalidated since."""
        loop = asyncio.get_event_loop()
        per_worker = MAX_TRANSMISSIONS_PER_BATCH // len(self.workers)
        transmissions: dict = {}
        for worker in self.workers:
            included = 0
            while included < per_worker:
                batch = worker.drain(per_worker - included)
                if not batch:
                    break
                for tid, t in batch.items():
                    if self.ledger.contains_transmission(tid):
                        continue  # committed since ingest
                    if transmissions and self.storage.contains_transmission(tid):
                        continue  # already in another certified batch
                    if tid.kind != t.kind:
                        continue
                    try:
                        obj = t.deserialize()
                    except Exception:
                        continue
                    try:
                        from snarkos_tpu_torch.node import types as _ty

                        if t.kind == _ty.TX_SOLUTION:
                            await loop.run_in_executor(
                                None, self.ledger.check_solution_basic, obj)
                        else:
                            await loop.run_in_executor(
                                None, self.ledger.check_transaction_basic, obj)
                    except Exception as exc:
                        if self.on_fault is not None and self.on_fault(exc, "proposal re-check"):
                            raise
                        log.debug("proposing - skipping %s: %s", tid, exc)
                        continue
                    transmissions[tid] = t
                    included += 1
        return transmissions

    def reinsert_transmissions(self, transmissions: dict) -> None:
        """Route transmissions back to their assigned workers
        (partition.rs assign_to_workers)."""
        n = len(self.workers)
        for tid, t in transmissions.items():
            self.workers[assign_to_worker(tid, n)].reinsert({tid: t})

    def worker_for(self, tid: TransmissionID) -> Worker:
        return self.workers[assign_to_worker(tid, len(self.workers))]

    async def process_unconfirmed_solution(self, sol: Solution) -> None:
        await self.worker_for(sol.id).process_unconfirmed_solution(sol)

    async def process_unconfirmed_transaction(self, tx: Transaction) -> None:
        await self.worker_for(tx.id).process_unconfirmed_transaction(tx)

    def process_worker_ping(self, peer_addr, ping: ev.WorkerPing) -> None:
        """Partition the advertised ids to their assigned workers
        (gateway.rs WorkerPing dispatch via assign_to_worker)."""
        if len(self.workers) == 1:
            self.worker.process_worker_ping(peer_addr, ping)
            return
        buckets: dict[int, list] = {}
        for tid in ping.transmission_ids:
            buckets.setdefault(assign_to_worker(tid, len(self.workers)), []).append(tid)
        for wid, tids in buckets.items():
            self.workers[wid].process_worker_ping(
                peer_addr, ev.WorkerPing(tuple(tids)))

    def clear_worker_solutions(self) -> None:
        """Drop queued solutions on epoch rollover
        (consensus/src/lib.rs:504-509 -> primary.rs clear_worker_solutions)."""
        from snarkos_tpu_torch.node import types as _ty

        for worker in self.workers:
            for tid in [t for t in worker.ready if t.kind == _ty.TX_SOLUTION]:
                worker.ready.pop(tid, None)

    # -- peer proposal -> sign (primary.rs:632-800) --------------------------
    async def process_batch_propose(self, peer_addr, propose: ev.BatchPropose) -> None:
        header = propose.deserialize()
        author = header.author
        if author == self.address:
            return
        committee = self.ledger.committee_lookback_for(header.round)
        if not committee.is_member(author):
            raise ValueError("proposal from non-committee member")
        if header.committee_id != committee.id:
            raise ValueError("proposal committee id mismatch")
        if abs(header.timestamp - time.time()) > MAX_TIMESTAMP_DELTA_S + MAX_BATCH_DELAY_S * 4:
            raise ValueError("proposal timestamp out of range")
        # one-signature-per-round rule (signed_proposals.rs:30)
        seen = self.signed_proposals.get(author)
        if seen is not None and seen[0] == header.round and seen[1] != header.batch_id:
            raise ValueError("peer proposed two different batches in one round")
        if seen is not None and seen[0] == header.round and seen[1] == header.batch_id:
            sig = seen[2]
            self.transport.send(peer_addr, ev.BatchSignature(header.batch_id, sig))
            return
        # fetch anything missing (transmissions; previous certificates)
        await self._sync_with_batch_header(peer_addr, header)
        available = {}
        for tid in header.transmission_ids:
            w = self.worker_for(tid)
            if tid in w.ready:
                available[tid] = w.ready[tid]
        missing = self.storage.check_batch_header(header, available)
        if missing:
            raise ValueError(f"still missing {len(missing)} transmissions after sync")
        sig = edwards.sign_bytes(self.account.sk, self.account.pk, header.batch_id)
        self.signed_proposals[author] = (header.round, header.batch_id, sig)
        self.transport.send(peer_addr, ev.BatchSignature(header.batch_id, sig))

    async def _sync_with_batch_header(self, peer_addr, header: BatchHeader) -> None:
        """Fetch missing previous certificates and transmissions
        (primary.rs:1521-1705)."""
        if header.round > 1:
            for cid in header.previous_certificate_ids:
                if not self.storage.contains_certificate(cid):
                    await self.fetch_certificate(peer_addr, cid)
        known = {}
        for w in self.workers:
            known.update(w.ready)
        missing = self.storage.store.find_missing_transmissions(header, known)
        for tid in missing:
            w = self.worker_for(tid)
            t = await w.fetch_transmission(peer_addr, tid)
            w.ready.setdefault(tid, t)

    # -- signatures -> certificate (primary.rs:810-906) ----------------------
    async def process_batch_signature(self, peer_addr, sig_event: ev.BatchSignature,
                                      signer: str) -> None:
        proposal = self.proposed_batch
        if proposal is None or proposal.batch_id != sig_event.batch_id:
            return
        committee = self.ledger.committee_lookback_for(proposal.round)
        proposal.add_signature(signer, sig_event.signature, committee)
        if proposal.is_quorum(committee):
            await self._store_and_broadcast_certificate()

    async def _store_and_broadcast_certificate(self) -> None:
        """primary.rs:1411-1437."""
        proposal = self.proposed_batch
        if proposal is None:
            return
        cert = proposal.to_certificate()
        self.storage.insert_certificate(cert, proposal.transmissions)
        self.proposed_batch = None
        self.latest_certificate = cert
        if self.on_certificate is not None:
            await self.on_certificate(cert)
        self.transport.broadcast(ev.BatchCertified(cert.to_bytes()))
        await self.try_increment_to_the_next_round(cert.round + 1)

    # -- peer certificates (primary.rs:914-984) ------------------------------
    async def process_batch_certified(self, peer_addr, event: ev.BatchCertified) -> None:
        cert = event.deserialize()
        if cert.author == self.address:
            return
        await self._receive_certificate(peer_addr, cert)

    async def _receive_certificate(self, peer_addr, cert: BatchCertificate) -> None:
        if self.storage.contains_certificate(cert.id):
            return
        # catch up on ancestry first
        if cert.round > 1:
            for cid in cert.batch_header.previous_certificate_ids:
                if not self.storage.contains_certificate(cid) and cert.round - 1 > self.storage.gc_round():
                    await self.fetch_certificate(peer_addr, cid)
        missing = self.storage.check_certificate(cert, {})
        transmissions = {}
        for tid in missing:
            transmissions[tid] = await self.worker_for(tid).fetch_transmission(peer_addr, tid)
        self.storage.insert_certificate(cert, transmissions)
        if self.on_certificate is not None:
            await self.on_certificate(cert)
        # a quorum of certs in our current round lets us advance
        round_ = self.storage.current_round()
        certs = self.storage.get_certificates_for_round(round_)
        committee = self.ledger.committee_lookback_for(round_)
        if committee.is_quorum([c.author for c in certs]):
            await self.try_increment_to_the_next_round(round_ + 1)

    # -- certificate fetch (pending-queue equivalent) ------------------------
    _cert_futures: dict = None

    async def fetch_certificate(self, peer_addr, cert_id: bytes) -> None:
        if self._cert_futures is None:
            self._cert_futures = {}
        if self.storage.contains_certificate(cert_id):
            return
        fut = self._cert_futures.get(cert_id)
        if fut is None:
            fut = asyncio.get_event_loop().create_future()
            self._cert_futures[cert_id] = fut
            self.transport.send(peer_addr, ev.CertificateRequest(cert_id))
        await asyncio.wait_for(asyncio.shield(fut), MAX_FETCH_TIMEOUT_S)

    async def process_certificate_response(self, peer_addr, resp: ev.CertificateResponse) -> None:
        if resp.certificate is None:
            return
        cert = BatchCertificate.from_bytes(resp.certificate)
        if cert.id != resp.certificate_id:
            raise ValueError("certificate response id mismatch")
        fut = (self._cert_futures or {}).pop(cert.id, None)
        try:
            if not self.storage.contains_certificate(cert.id):
                await self._receive_certificate(peer_addr, cert)
        except Exception as exc:
            if fut is not None and not fut.done():
                fut.set_exception(exc)
            raise
        if fut is not None and not fut.done():
            fut.set_result(cert)

    def serve_certificate_request(self, peer_addr, req: ev.CertificateRequest) -> None:
        cert = self.storage.get_certificate(req.certificate_id)
        self.transport.send(
            peer_addr,
            ev.CertificateResponse(req.certificate_id, cert.to_bytes() if cert else None),
        )

    # -- round advancement (primary.rs:1310-1357) ----------------------------
    async def try_increment_to_the_next_round(self, next_round: int) -> None:
        if next_round <= self.storage.current_round():
            return
        if self.on_round_advance is not None:
            # BFT-mode: the committer decides when to move (bft.rs:199-264)
            await self.on_round_advance(next_round)
        else:
            self.storage.increment_to_next_round(next_round)

    # -- loops ---------------------------------------------------------------
    # -- crash recovery (helpers/proposal_cache.rs; SURVEY.md §6.4) ----------
    def load_proposal_cache(self, path: str) -> None:
        """Reload and replay a persisted proposal cache (primary.rs:142-179)."""
        from snarkos_tpu_torch.node import proposal_cache as pc

        out = pc.load(path, self.address)
        if out is None:
            return
        current_round, proposal_parts, signed_proposals, certificates = out
        self.signed_proposals.update(signed_proposals)
        if proposal_parts is not None:
            header, transmissions, signatures = proposal_parts
            self.proposed_batch = Proposal(
                batch_header=header, transmissions=transmissions,
                signatures=signatures,
            )
        for cert in certificates:
            try:
                self.storage.sync_certificate_with_block(
                    cert, self.proposed_batch.transmissions if self.proposed_batch else {}
                )
            except Exception as exc:
                log.debug("proposal cache: certificate replay failed: %s", exc)
        self.storage.increment_to_next_round(current_round)
        log.info("restored proposal cache at round %d", current_round)

    def store_proposal_cache(self, path: str) -> None:
        """Persist crash-recovery state (primary.rs:1714-1751 shut_down)."""
        from snarkos_tpu_torch.node import proposal_cache as pc

        pending = [
            c for r in range(self.storage.gc_round() + 1, self.storage.current_round() + 1)
            for c in self.storage.get_certificates_for_round(r)
        ]
        pc.store(path, self.address, self.storage.current_round(),
                 self.proposed_batch, self.signed_proposals, pending)

    async def run(self) -> None:
        self.running = True
        self._tasks.append(asyncio.create_task(self._batch_proposer_loop()))
        self._tasks.append(asyncio.create_task(self._worker_ping_loop()))
        self._tasks.append(asyncio.create_task(self._expiry_loop()))
        self._tasks.append(asyncio.create_task(self._primary_ping_loop()))

    async def _primary_ping_loop(self) -> None:
        while self.running:
            try:
                await asyncio.sleep(PRIMARY_PING_S)
                cert = self.latest_certificate
                self.transport.broadcast(ev.PrimaryPing(
                    ev.VERSION, self.ledger.latest_height(),
                    cert.to_bytes() if cert else None,
                ))
            except asyncio.CancelledError:
                return
            except Exception as exc:
                log.debug("primary ping loop error: %s", exc)

    async def shut_down(self) -> None:
        self.running = False
        for t in self._tasks:
            t.cancel()

    async def _batch_proposer_loop(self) -> None:
        while self.running:
            try:
                await asyncio.sleep(MIN_BATCH_DELAY_S)
                if time.time() - self.last_proposal_time >= MIN_BATCH_DELAY_S:
                    proposed = await self.propose_batch()
                    # re-broadcast an in-flight proposal so peers that missed
                    # it (e.g. joined after the original send) can sign
                    prop = self.proposed_batch
                    if not proposed and prop is not None and prop.round == self.storage.current_round():
                        self.transport.broadcast(
                            ev.BatchPropose(prop.round, prop.batch_header.to_bytes())
                        )
            except asyncio.CancelledError:
                return
            except Exception as exc:
                if self.on_fault is not None and self.on_fault(exc, "batch proposer"):
                    return
                log.debug("proposer loop error: %s", exc)

    async def _worker_ping_loop(self) -> None:
        while self.running:
            try:
                await asyncio.sleep(WORKER_PING_S)
                ids = tuple(t for w in self.workers for t in w.advertised_ids())
                if ids:
                    self.transport.broadcast(ev.WorkerPing(ids))
            except asyncio.CancelledError:
                return
            except Exception as exc:
                log.debug("worker ping loop error: %s", exc)

    async def _expiry_loop(self) -> None:
        while self.running:
            try:
                await asyncio.sleep(1.0)
                now = time.time()
                for w in self.workers:
                    for tid in [t for t, exp in w.pending_expiry.items() if exp < now]:
                        w.pending.pop(tid, None)
                        w.pending_expiry.pop(tid, None)
            except asyncio.CancelledError:
                return
