"""The Bullshark-style committer on top of the primary (node/bft/src/bft.rs).

Semantics reproduced (SURVEY.md §2.5 "BFT"):
- Round advancement: even rounds wait for the elected leader's certificate
  (or a timeout); odd rounds need quorum + leader-support stake reaching
  the availability threshold, or quorum without the leader, or timeout
  (bft.rs:271-446).
- Commit: on inserting a certificate of round r (even r-1 = commit round),
  elect the leader of the commit round, check the availability threshold
  of round-r certificates linking to it, then walk back linked leader
  certificates two rounds at a time and order each anchor's causal
  history deterministically via DFS (bft.rs:451-781).

The port of ``snarkos_tpu/node/bft/bft.py``: the same rules, so that both
packages commit the same subdags from the same certificates.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Optional

from snarkos_tpu_torch.node.bft.dag import DAG
from snarkos_tpu_torch.node.bft.primary import MAX_LEADER_CERTIFICATE_DELAY_S, Primary
from snarkos_tpu_torch.node.bft.storage import MAX_GC_ROUNDS
from snarkos_tpu_torch.node.types import BatchCertificate, Subdag

log = logging.getLogger(__name__)


class BFT:
    def __init__(self, primary: Primary,
                 on_commit: Optional[Callable] = None):
        """on_commit: async fn(subdag: Subdag, transmissions: dict)."""
        self.primary = primary
        self.storage = primary.storage
        self.ledger = primary.ledger
        self.dag = DAG()
        self.on_commit = on_commit
        # serializes the commit path: _update_dag awaits on_commit (which
        # yields to the event loop) before dag.commit records the anchor, so
        # without a lock a second certificate arriving mid-commit re-commits
        # the same anchor (divergent duplicate blocks across validators)
        self._commit_lock = asyncio.Lock()
        self.leader_certificate: Optional[BatchCertificate] = None
        self.leader_certificate_timer = 0.0
        primary.on_certificate = self._on_primary_certificate
        primary.on_round_advance = self._on_round_advance

    # -- round advancement (bft.rs:199-446) ----------------------------------
    async def _on_round_advance(self, next_round: int) -> None:
        current = self.storage.current_round()
        if next_round <= current:
            return
        if current % 2 == 0:
            ready = self._is_even_round_ready(current)
        else:
            ready = self._is_odd_round_ready(current)
        if ready:
            self.leader_certificate = None
            self.leader_certificate_timer = 0.0
            self.storage.increment_to_next_round(next_round)
            # moving into an even round: elect + look for the leader cert
            new_round = self.storage.current_round()
            if new_round % 2 == 0:
                committee = self.ledger.committee_lookback_for(new_round)
                leader = committee.get_leader(new_round)
                self.leader_certificate = next(
                    (c for c in self.storage.get_certificates_for_round(new_round)
                     if c.author == leader),
                    None,
                )
                self.leader_certificate_timer = time.time()

    def _is_even_round_ready(self, round_: int) -> bool:
        """bft.rs:271-363: wait for the leader certificate or timeout."""
        certs = self.storage.get_certificates_for_round(round_)
        committee = self.ledger.committee_lookback_for(round_)
        if not committee.is_quorum([c.author for c in certs]):
            return False
        leader = committee.get_leader(round_)
        if any(c.author == leader for c in certs):
            return True
        return (
            self.leader_certificate_timer > 0
            and time.time() - self.leader_certificate_timer > MAX_LEADER_CERTIFICATE_DELAY_S
        )

    def _is_odd_round_ready(self, round_: int) -> bool:
        """bft.rs:369-446."""
        certs = self.storage.get_certificates_for_round(round_)
        committee = self.ledger.committee_lookback_for(round_)
        if not committee.is_quorum([c.author for c in certs]):
            return False
        leader_cert = self.leader_certificate
        if leader_cert is None:
            # no leader seen in the previous even round: quorum suffices
            # after the leader timeout
            if self.leader_certificate_timer == 0:
                return True
            return time.time() - self.leader_certificate_timer > MAX_LEADER_CERTIFICATE_DELAY_S
        # leader support: stake of certs linking back to the leader cert
        supporters = [
            c.author for c in certs
            if leader_cert.id in c.batch_header.previous_certificate_ids
        ]
        if committee.is_availability(supporters):
            return True
        return time.time() - self.leader_certificate_timer > MAX_LEADER_CERTIFICATE_DELAY_S

    # -- DAG update & commit (bft.rs:451-713) --------------------------------
    async def _on_primary_certificate(self, cert: BatchCertificate) -> None:
        self.dag.insert(cert)
        if cert.round % 2 == 0 and self.leader_certificate is None:
            committee = self.ledger.committee_lookback_for(cert.round)
            if cert.author == committee.get_leader(cert.round) and cert.round == self.storage.current_round():
                self.leader_certificate = cert
        await self._update_dag(cert)

    async def _update_dag(self, cert: BatchCertificate) -> None:
        commit_round = cert.round - 1
        if commit_round % 2 != 0 or commit_round <= self.dag.last_committed_round:
            return
        committee = self.ledger.committee_lookback_for(commit_round)
        leader = committee.get_leader(commit_round)
        leader_cert = self.dag.get(commit_round, leader)
        if leader_cert is None:
            return
        # availability threshold of round-r certs linking to the leader
        supporters = [
            c.author
            for c in self.dag.round(commit_round + 1).values()
            if leader_cert.id in c.batch_header.previous_certificate_ids
        ]
        if not committee.is_availability(supporters):
            return
        async with self._commit_lock:
            if commit_round <= self.dag.last_committed_round:
                return
            await self._commit_leader_certificate(leader_cert)

    async def _commit_leader_certificate(self, leader_cert: BatchCertificate) -> None:
        """bft.rs:532-713: walk back linked prior leaders, then commit each
        anchor in ascending order with its DFS-ordered causal history."""
        # walk back even rounds while linked
        anchors = [leader_cert]
        current = leader_cert
        round_ = leader_cert.round - 2
        while round_ > max(self.dag.last_committed_round, 0):
            committee = self.ledger.committee_lookback_for(round_)
            prev_leader = self.dag.get(round_, committee.get_leader(round_))
            if prev_leader is not None and self._is_linked(prev_leader, current):
                anchors.append(prev_leader)
                current = prev_leader
            round_ -= 2
        for anchor in reversed(anchors):
            await self._commit_anchor(anchor)

    def _is_linked(self, earlier: BatchCertificate, later: BatchCertificate) -> bool:
        """bft.rs:784-806: path of previous-certificate links."""
        frontier = {later.id: later}
        for r in range(later.round, earlier.round, -1):
            next_frontier = {}
            for cert in frontier.values():
                for cid in cert.batch_header.previous_certificate_ids:
                    prev = self.dag.get_by_id(r - 1, cid)
                    if prev is not None:
                        next_frontier[prev.id] = prev
            frontier = next_frontier
            if not frontier:
                return False
        return earlier.id in frontier

    async def _commit_anchor(self, anchor: BatchCertificate) -> None:
        ordered = self._order_dag_with_dfs(anchor)
        # gather transmissions, dedup against ledger
        transmissions: dict = {}
        rounds: dict[int, list] = {}
        for cert in ordered:
            rounds.setdefault(cert.round, []).append(cert)
            for tid in cert.batch_header.transmission_ids:
                if tid in transmissions or self.ledger.contains_transmission(tid):
                    continue
                t = self.storage.get_transmission(tid)
                if t is not None:
                    transmissions[tid] = t
        # leader cert must be FIRST in its round tuple (Subdag convention)
        anchor_round_list = rounds.get(anchor.round, [])
        anchor_round_list.sort(key=lambda c: (c.id != anchor.id, c.id))
        subdag = Subdag(
            rounds=tuple(sorted((r, tuple(cs)) for r, cs in rounds.items()))
        )
        if self.on_commit is not None:
            await self.on_commit(subdag, transmissions)
        for cert in ordered:
            self.dag.commit(cert, MAX_GC_ROUNDS)
        self.storage.garbage_collect(anchor.round - MAX_GC_ROUNDS)

    def _order_dag_with_dfs(self, anchor: BatchCertificate) -> list:
        """bft.rs:716-781: deterministic causal ordering below the anchor."""
        ordered: list[BatchCertificate] = []
        seen: set[bytes] = set()

        def visit(cert: BatchCertificate):
            if cert.id in seen or self.dag.is_recently_committed(cert.round, cert.id):
                return
            seen.add(cert.id)
            if cert.round > 1:
                for cid in sorted(cert.batch_header.previous_certificate_ids):
                    c = self.dag.get_by_id(cert.round - 1, cid)
                    if c is not None:
                        visit(c)
            ordered.append(cert)

        visit(anchor)
        return ordered
