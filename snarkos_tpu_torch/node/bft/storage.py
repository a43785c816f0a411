"""Narwhal storage: rounds, certificates, batch ids, transmissions, GC.

Re-creates `node/bft/src/helpers/storage.rs:38-592` semantics: an
in-memory map of round -> certificates plus a pluggable transmission
store, with `current_round`/`gc_round` tracking, atomic certificate
insertion (certificate + its transmissions), batch-header checking
(missing-transmission discovery), and garbage collection of rounds
below the GC window.

The port of ``snarkos_tpu/node/bft/storage.py``: a journal written by
either package loads in the other.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Iterable, Optional

from snarkos_tpu_torch.node.types import (
    BatchCertificate,
    BatchHeader,
    Transmission,
    TransmissionID,
)

MAX_GC_ROUNDS = 50  # reference: snarkVM BatchHeader::MAX_GC_ROUNDS


class StorageService:
    """Transmission store seam (storage-service/src/traits.rs:28-60)."""

    def contains_transmission(self, tid: TransmissionID) -> bool: raise NotImplementedError
    def get_transmission(self, tid: TransmissionID) -> Optional[Transmission]: raise NotImplementedError
    def find_missing_transmissions(self, header: BatchHeader, transmissions: dict) -> list:
        raise NotImplementedError
    def insert_transmissions(self, cert_id: bytes, tids: Iterable[TransmissionID],
                             transmissions: dict) -> None: raise NotImplementedError
    def remove_transmissions(self, cert_id: bytes, tids: Iterable[TransmissionID]) -> None:
        raise NotImplementedError


class BFTMemoryService(StorageService):
    """HashMap-backed store with per-certificate refcounts (memory.rs:29)."""

    def __init__(self):
        self.transmissions: dict[TransmissionID, tuple[Transmission, set]] = {}

    def contains_transmission(self, tid):
        return tid in self.transmissions

    def get_transmission(self, tid):
        entry = self.transmissions.get(tid)
        return entry[0] if entry else None

    def find_missing_transmissions(self, header, transmissions):
        return [
            tid for tid in header.transmission_ids
            if tid not in self.transmissions and tid not in transmissions
        ]

    def insert_transmissions(self, cert_id, tids, transmissions):
        for tid in tids:
            if tid in self.transmissions:
                self.transmissions[tid][1].add(cert_id)
            elif tid in transmissions:
                self.transmissions[tid] = (transmissions[tid], {cert_id})

    def remove_transmissions(self, cert_id, tids):
        for tid in tids:
            entry = self.transmissions.get(tid)
            if entry is None:
                continue
            entry[1].discard(cert_id)
            if not entry[1]:
                del self.transmissions[tid]


class BFTPersistentService(BFTMemoryService):
    """Disk-backed variant (persistent.rs:45-79): append-log of inserts,
    replayed at startup. Round-1 implementation: memory + journal."""

    def __init__(self, path: str):
        super().__init__()
        import os

        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            self._replay()
        self._fh = open(path, "ab")

    def _replay(self):
        from snarkos_tpu_torch.node.codec import Reader

        with open(self.path, "rb") as f:
            data = f.read()
        r = Reader(data)
        while not r.done():
            try:
                cert_id = r.take(32)
                t = Transmission.from_reader(r)
            except Exception:
                break
            self.transmissions.setdefault(t.id, (t, set()))[1].add(cert_id)

    def insert_transmissions(self, cert_id, tids, transmissions):
        from snarkos_tpu_torch.node.codec import Writer

        for tid in tids:
            if tid not in self.transmissions and tid in transmissions:
                w = Writer().raw(cert_id).raw(transmissions[tid].to_bytes())
                self._fh.write(w.out())
        self._fh.flush()
        super().insert_transmissions(cert_id, tids, transmissions)


class NarwhalStorage:
    """The DAG-adjacent certificate store (helpers/storage.rs)."""

    def __init__(self, ledger, store: StorageService, gc_rounds: int = MAX_GC_ROUNDS):
        self.ledger = ledger
        self.store = store
        self.gc_rounds = gc_rounds
        self.lock = threading.RLock()
        self.current_round_ = max(1, ledger.latest_round() + 1)
        self.gc_round_ = max(0, self.current_round_ - gc_rounds)
        # round -> {cert_id: certificate}
        self.rounds: dict[int, dict[bytes, BatchCertificate]] = defaultdict(dict)
        self.certificates: dict[bytes, BatchCertificate] = {}
        self.batch_ids: dict[bytes, int] = {}  # batch_id -> round

    # -- round state ---------------------------------------------------------
    def current_round(self) -> int:
        return self.current_round_

    def gc_round(self) -> int:
        return self.gc_round_

    def increment_to_next_round(self, next_round: int) -> None:
        """storage.rs:153-203: advance current_round (monotonic) and GC."""
        with self.lock:
            if next_round > self.current_round_:
                self.current_round_ = next_round
                self.garbage_collect(next_round - self.gc_rounds)

    def garbage_collect(self, new_gc_round: int) -> None:
        with self.lock:
            if new_gc_round <= self.gc_round_:
                return
            for r in [r for r in self.rounds if r <= new_gc_round]:
                for cid, cert in self.rounds.pop(r).items():
                    self.certificates.pop(cid, None)
                    self.batch_ids.pop(cert.batch_header.batch_id, None)
                    self.store.remove_transmissions(cid, cert.batch_header.transmission_ids)
            self.gc_round_ = new_gc_round

    # -- queries -------------------------------------------------------------
    def contains_certificate(self, cert_id: bytes) -> bool:
        return cert_id in self.certificates

    def contains_batch(self, batch_id: bytes) -> bool:
        return batch_id in self.batch_ids

    def get_certificate(self, cert_id: bytes) -> Optional[BatchCertificate]:
        return self.certificates.get(cert_id)

    def get_certificates_for_round(self, round_: int) -> list[BatchCertificate]:
        return list(self.rounds.get(round_, {}).values())

    def get_certificate_for_round_with_author(self, round_: int, author) -> Optional[BatchCertificate]:
        for cert in self.rounds.get(round_, {}).values():
            if cert.author == author:
                return cert
        return None

    def contains_transmission(self, tid: TransmissionID) -> bool:
        return self.store.contains_transmission(tid)

    def get_transmission(self, tid: TransmissionID) -> Optional[Transmission]:
        return self.store.get_transmission(tid)

    # -- checks (storage.rs:368-533) ----------------------------------------
    def check_batch_header(self, header: BatchHeader, transmissions: dict) -> list:
        """Validates a proposed batch header; returns the list of missing
        transmission ids that must be fetched before signing."""
        if self.contains_batch(header.batch_id):
            raise ValueError("batch already exists in storage")
        if header.round < self.gc_round_ + 1:
            raise ValueError(f"batch round {header.round} is below GC round")
        committee = self.ledger.committee_lookback_for(header.round)
        if not committee.is_member(header.author):
            raise ValueError("batch author is not a committee member")
        if not header.verify_signature():
            raise ValueError("invalid batch signature")
        if len(header.transmission_ids) > BatchHeader.MAX_TRANSMISSIONS_PER_BATCH:
            raise ValueError("too many transmissions in batch")
        self._check_previous_certificates(header)
        return self.store.find_missing_transmissions(header, transmissions)

    def _check_previous_certificates(self, header: BatchHeader):
        if header.round <= max(1, self.gc_round_ + 1):
            return  # no previous-round obligations at/below the GC horizon
        if header.round == 1:
            if header.previous_certificate_ids:
                raise ValueError("round 1 must have no previous certificates")
            return
        prev_round = header.round - 1
        committee = self.ledger.committee_lookback_for(prev_round)
        authors = []
        for cid in header.previous_certificate_ids:
            cert = self.certificates.get(cid)
            if cert is None:
                raise ValueError(f"missing previous certificate {cid.hex()[:16]}")
            if cert.round != prev_round:
                raise ValueError("previous certificate from wrong round")
            authors.append(cert.author)
        if not committee.is_quorum(authors):
            raise ValueError("previous certificates do not reach quorum")

    def check_certificate(self, cert: BatchCertificate, transmissions: dict) -> list:
        """storage.rs:465: full certificate check; returns missing tids."""
        if self.contains_certificate(cert.id):
            raise ValueError("certificate already in storage")
        committee = self.ledger.committee_lookback_for(cert.round)
        if not cert.verify(committee):
            raise ValueError("certificate verification failed")
        if cert.round < max(1, self.gc_round_ + 1):
            raise ValueError("certificate round below GC round")
        missing = [
            tid for tid in cert.batch_header.transmission_ids
            if not self.store.contains_transmission(tid) and tid not in transmissions
        ]
        return missing

    # -- insertion (storage.rs:535-592) -------------------------------------
    def insert_certificate(self, cert: BatchCertificate, transmissions: dict) -> None:
        """Atomic insert of certificate + transmissions. ``transmissions``
        maps TransmissionID -> Transmission for any not already stored."""
        with self.lock:
            missing = self.check_certificate(cert, transmissions)
            if missing:
                raise ValueError(f"missing {len(missing)} transmissions for certificate")
            self._insert_unchecked(cert, transmissions)

    def _insert_unchecked(self, cert: BatchCertificate, transmissions: dict) -> None:
        with self.lock:
            self.rounds[cert.round][cert.id] = cert
            self.certificates[cert.id] = cert
            self.batch_ids[cert.batch_header.batch_id] = cert.round
            self.store.insert_transmissions(
                cert.id, cert.batch_header.transmission_ids, transmissions
            )

    def sync_certificate_with_block(self, cert: BatchCertificate, transmissions: dict) -> None:
        """storage.rs:658: insert a certificate learned from a synced block
        (no quorum re-check: the block itself was validated)."""
        with self.lock:
            if self.contains_certificate(cert.id) or cert.round <= self.gc_round_:
                return
            self._insert_unchecked(cert, transmissions)
