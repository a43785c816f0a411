"""The commit DAG (node/bft/src/helpers/dag.rs:26-136 semantics):
round -> author -> certificate, with recently-committed tracking and GC.
The port of ``snarkos_tpu/node/bft/dag.py``."""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

from snarkos_tpu_torch.node.types import BatchCertificate


class DAG:
    def __init__(self):
        self.graph: dict[int, dict[str, BatchCertificate]] = defaultdict(dict)
        # per-round certificate-id index: previous-certificate link lookups
        # during commit (is_linked / DFS ordering) must be O(1), not a
        # linear scan of the round — O(committee^2) per commit otherwise
        self.by_id: dict[int, dict[bytes, BatchCertificate]] = defaultdict(dict)
        self.recent_committed_ids: set[bytes] = set()
        self.last_committed_round = 0

    def insert(self, cert: BatchCertificate) -> None:
        if cert.id in self.recent_committed_ids:
            return
        prev = self.graph[cert.round].get(cert.author)
        if prev is not None:
            self.by_id[cert.round].pop(prev.id, None)
        self.graph[cert.round][cert.author] = cert
        self.by_id[cert.round][cert.id] = cert

    def contains(self, cert_id: bytes, round_: int) -> bool:
        return cert_id in self.by_id.get(round_, {})

    def get(self, round_: int, author: str) -> Optional[BatchCertificate]:
        return self.graph.get(round_, {}).get(author)

    def get_by_id(self, round_: int, cert_id: bytes) -> Optional[BatchCertificate]:
        return self.by_id.get(round_, {}).get(cert_id)

    def round(self, round_: int) -> dict:
        return self.graph.get(round_, {})

    def is_recently_committed(self, round_: int, cert_id: bytes) -> bool:
        return cert_id in self.recent_committed_ids

    def commit(self, cert: BatchCertificate, max_gc_rounds: int) -> None:
        """Mark committed and GC rounds <= round - max_gc_rounds."""
        self.recent_committed_ids.add(cert.id)
        self.last_committed_round = max(self.last_committed_round, cert.round)
        entry = self.graph.get(cert.round)
        if entry is not None:
            entry.pop(cert.author, None)
            if not entry:
                del self.graph[cert.round]
        ids = self.by_id.get(cert.round)
        if ids is not None:
            ids.pop(cert.id, None)
            if not ids:
                self.by_id.pop(cert.round, None)
        gc_below = self.last_committed_round - max_gc_rounds
        for r in [r for r in self.graph if r <= gc_below]:
            del self.graph[r]
        for r in [r for r in self.by_id if r <= gc_below]:
            del self.by_id[r]
