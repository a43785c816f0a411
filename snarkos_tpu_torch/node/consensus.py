"""Consensus facade: mempool intake + subdag -> block advancement.

Re-creates `node/consensus/src/lib.rs:90-530` (SURVEY.md §1 layer 5):
``add_unconfirmed_solution`` / ``add_unconfirmed_transaction`` with seen-
LRU + ledger-contains gates and deploy/execute interleaving, and the
commit path: BFT subdag -> prepare block -> check -> advance, reinserting
transmissions into the worker on failure.

The port of ``snarkos_tpu/node/consensus.py``. It picks no device: the
ledger service passed in runs every check (intake, the proposal re-checks,
``check_next_block`` at each commit) on its own ledger's device, the card
for a ``CoreLedgerService`` over a ``Ledger`` made with the default device.

One rule differs from the reference (the roles' fault rule, ROADMAP C): a
device fault (``ledger.is_device_fault``) in the mempool drain, the
proposal re-checks or a commit's block advance is not logged and passed
over. It is kept as ``fault`` and handed to ``on_fault`` (the node stops),
or, with no ``on_fault``, logged at ERROR and consensus shut down. What
the reference refuses on content keeps the reference's handling.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict
from typing import Optional

from snarkos_tpu_torch.node.bft.bft import BFT
from snarkos_tpu_torch.node.bft.primary import Primary
from snarkos_tpu_torch.node.bft.storage import BFTMemoryService, NarwhalStorage, StorageService
from snarkos_tpu_torch.node.ledger import is_device_fault
from snarkos_tpu_torch.node.types import Block, Solution, Subdag, Transaction

log = logging.getLogger(__name__)

CAPACITY_FOR_SOLUTIONS = 1 << 10
CAPACITY_FOR_TRANSACTIONS = 1 << 12


class Consensus:
    def __init__(self, account, ledger, transport,
                 storage_service: Optional[StorageService] = None,
                 on_block: Optional[callable] = None,
                 on_fault: Optional[callable] = None):
        self.ledger = ledger
        storage_service = storage_service or BFTMemoryService()
        self.storage = NarwhalStorage(ledger, storage_service)
        self.primary = Primary(account, ledger, self.storage, transport)
        self.bft = BFT(self.primary, on_commit=self._process_bft_subdag)
        self.seen_solutions: OrderedDict = OrderedDict()
        self.seen_transactions: OrderedDict = OrderedDict()
        self.solutions_queue: OrderedDict = OrderedDict()
        self.deployments_queue: OrderedDict = OrderedDict()
        self.executions_queue: OrderedDict = OrderedDict()
        self.on_block = on_block  # async fn(block) — e.g. gossip hooks
        self.on_fault = on_fault  # fn(exc, where): a device fault stops the node
        self.fault: Optional[BaseException] = None
        self.primary.on_fault = self._halt_on_fault
        # near-tip sync buffer (sync/mod.rs latest_block_responses)
        self.latest_block_responses: dict[int, Block] = {}
        self._running = False

    # -- lifecycle -----------------------------------------------------------
    async def run(self):
        self._running = True
        self.sync_storage_with_ledger_at_bootup()
        await self.primary.run()
        asyncio.create_task(self._mempool_drain_loop())

    def sync_storage_with_ledger_at_bootup(self) -> None:
        """Replay the last GC window of persisted blocks into Narwhal
        storage + the commit DAG so a restarted validator rejoins consensus
        at the chain tip instead of round 1 (node/bft/src/sync/mod.rs:224-296)."""
        from snarkos_tpu_torch.node.bft.storage import MAX_GC_ROUNDS

        tip_round = self.ledger.latest_round()
        if tip_round == 0:
            return
        gc_floor = max(1, tip_round - MAX_GC_ROUNDS)
        for height in range(self.ledger.latest_height(), 0, -1):
            block = self.ledger.get_block(height)
            if block.round < gc_floor:
                break
            self._replay_block_into_narwhal(block)
        self.dag.last_committed_round = max(self.dag.last_committed_round, tip_round)
        self.storage.increment_to_next_round(tip_round + 1)

    @property
    def dag(self):
        return self.bft.dag

    def _replay_block_into_narwhal(self, block: Block) -> None:
        if block.subdag is None:
            return
        transmissions = {t.id: t for t in block.transmissions}
        for cert in block.subdag.all_certificates():
            self.storage.sync_certificate_with_block(cert, transmissions)
            self.bft.dag.recent_committed_ids.add(cert.id)

    async def shut_down(self):
        self._running = False
        await self.primary.shut_down()

    def _halt_on_fault(self, exc: BaseException, where: str) -> bool:
        """Stop on ``exc`` if it is a device fault (True); else False, and the
        caller keeps the reference's handling."""
        if not is_device_fault(exc):
            return False
        if self.fault is None:
            self.fault = exc
            self._running = False
            if self.on_fault is not None:
                self.on_fault(exc, where)
            else:
                log.error("%s: device fault, stopping consensus", where, exc_info=exc)
                asyncio.get_running_loop().create_task(self.shut_down())
        return True

    # -- intake (consensus/lib.rs:288-443) -----------------------------------
    async def add_unconfirmed_solution(self, sol: Solution) -> None:
        sid = sol.id
        if sid in self.seen_solutions:
            raise ValueError("solution already seen")
        self._lru_insert(self.seen_solutions, sid, CAPACITY_FOR_SOLUTIONS * 4)
        if self.ledger.contains_transmission(sid):
            raise ValueError("solution already committed")
        if len(self.solutions_queue) >= CAPACITY_FOR_SOLUTIONS:
            raise ValueError("solutions queue is full")
        self.solutions_queue[sid] = sol

    async def add_unconfirmed_transaction(self, tx: Transaction) -> None:
        tid = tx.id
        if tid in self.seen_transactions:
            raise ValueError("transaction already seen")
        self._lru_insert(self.seen_transactions, tid, CAPACITY_FOR_TRANSACTIONS * 4)
        if self.ledger.contains_transmission(tid):
            raise ValueError("transaction already committed")
        queue = self.deployments_queue if tx.is_deploy else self.executions_queue
        if len(queue) >= CAPACITY_FOR_TRANSACTIONS:
            raise ValueError("transactions queue is full")
        queue[tid] = tx

    @staticmethod
    def _lru_insert(cache: OrderedDict, key, cap: int):
        cache[key] = True
        while len(cache) > cap:
            cache.popitem(last=False)

    async def _mempool_drain_loop(self):
        """Interleaved drain into the worker: solutions first, then <=1
        deployment per interval + executions (consensus/lib.rs:402-424)."""
        while self._running:
            try:
                await asyncio.sleep(0.25)
                for _ in range(min(len(self.solutions_queue), 8)):
                    _, sol = self.solutions_queue.popitem(last=False)
                    try:
                        await self.primary.process_unconfirmed_solution(sol)
                    except Exception as exc:
                        if self._halt_on_fault(exc, "solution intake"):
                            return
                        log.debug("solution rejected: %s", exc)
                if self.deployments_queue:
                    _, tx = self.deployments_queue.popitem(last=False)
                    try:
                        await self.primary.process_unconfirmed_transaction(tx)
                    except Exception as exc:
                        if self._halt_on_fault(exc, "deployment intake"):
                            return
                        log.debug("deployment rejected: %s", exc)
                for _ in range(min(len(self.executions_queue), 16)):
                    _, tx = self.executions_queue.popitem(last=False)
                    try:
                        await self.primary.process_unconfirmed_transaction(tx)
                    except Exception as exc:
                        if self._halt_on_fault(exc, "execution intake"):
                            return
                        log.debug("execution rejected: %s", exc)
            except asyncio.CancelledError:
                return
            except Exception as exc:
                if self._halt_on_fault(exc, "mempool drain"):
                    return
                log.debug("mempool drain error: %s", exc)

    # -- commit path (consensus/lib.rs:461-530) ------------------------------
    async def _process_bft_subdag(self, subdag: Subdag, transmissions: dict) -> None:
        t0 = time.time()
        try:
            block = await asyncio.get_event_loop().run_in_executor(
                None, self._try_advance, subdag, transmissions
            )
        except Exception as exc:
            if self._halt_on_fault(exc, "block advance"):
                return
            log.warning("block advance failed: %s; reinserting transmissions", exc)
            self.primary.reinsert_transmissions(transmissions)
            return
        log.info("advanced to block %d (round %d, %d transmissions)",
                 block.height, block.round, len(block.transmissions))
        # epoch rollover: queued solutions target the OLD epoch hash and can
        # never verify again — clear them (consensus/src/lib.rs:504-509)
        if block.height % Block.EPOCH_BLOCKS == 0:
            self.solutions_queue.clear()
            self.primary.clear_worker_solutions()
        self._update_block_metrics(block, time.time() - t0)
        if self.on_block is not None:
            await self.on_block(block)

    def _update_block_metrics(self, block: Block, advance_s: float) -> None:
        """consensus/src/lib.rs:489-528 equivalents."""
        from snarkos_tpu_torch.node import metrics, types

        n_sol = sum(1 for t in block.transmissions if t.kind == types.TX_SOLUTION)
        metrics.update_gauge("blocks_height", block.height)
        metrics.update_gauge("blocks_transmissions", len(block.transmissions))
        metrics.update_gauge("blocks_solutions", n_sol)
        metrics.update_gauge("blocks_transactions", len(block.transmissions) - n_sol)
        metrics.update_gauge("consensus_last_committed_round", block.round)
        metrics.update_gauge(
            "consensus_committed_certificates",
            sum(len(cs) for _, cs in block.subdag.rounds) if block.subdag else 0,
        )
        metrics.update_gauge("mempool_solutions", len(self.solutions_queue))
        metrics.update_gauge("mempool_transactions",
                             len(self.executions_queue) + len(self.deployments_queue))
        metrics.update_gauge("mempool_ready_transmissions", sum(len(w.ready) for w in self.primary.workers))
        metrics.observe_histogram("consensus_block_advance_seconds", advance_s)
        metrics.observe_histogram(
            "consensus_commit_latency_seconds", max(0.0, time.time() - block.timestamp)
        )

    def _try_advance(self, subdag: Subdag, transmissions: dict) -> Block:
        ordered = list(transmissions.values())
        block = self.ledger.prepare_advance_to_next_quorum_block(subdag, ordered)
        self.ledger.check_next_block(block)
        self.ledger.advance_to_next_block(block)
        return block

    # -- BFT-side block sync (node/bft/src/sync/mod.rs:299-513 semantics) ----
    def sync_with_block(self, block: Block) -> None:
        """Advance the ledger with a synced block and replay its subdag into
        Narwhal state so this node can rejoin consensus at the tip."""
        self.ledger.check_next_block(block)
        self.ledger.advance_to_next_block(block)
        if block.subdag is None:
            return
        self._replay_block_into_narwhal(block)
        anchor = block.subdag.anchor_round
        self.bft.dag.last_committed_round = max(self.bft.dag.last_committed_round, anchor)
        self.storage.increment_to_next_round(anchor + 1)
        # discard any stale in-flight proposal from the rounds we skipped
        prop = self.primary.proposed_batch
        if prop is not None and prop.round <= anchor:
            self.primary.reinsert_transmissions(prop.transmissions)
            self.primary.proposed_batch = None

    def is_deep_behind(self, tip_height: int) -> bool:
        """Deep-behind fast path gate (sync/mod.rs:308-314): if the tip is
        past what the peers would have garbage-collected, sync the ledger
        WITHOUT the BFT until back within GC range."""
        from snarkos_tpu_torch.node.bft.storage import MAX_GC_ROUNDS

        max_gc_height = max(0, tip_height - MAX_GC_ROUNDS // 2)
        return self.ledger.latest_height() + 1 <= max_gc_height

    def sync_ledger_with_block_without_bft(self, block: Block) -> None:
        """Deep-behind: advance the ledger only, tracking storage height/
        round (sync/mod.rs:342-362). Caller runs the bootup replay when
        crossing back into GC range."""
        self.ledger.check_next_block(block)
        self.ledger.advance_to_next_block(block)
        self.storage.increment_to_next_round(block.round + 1)

    def sync_storage_with_block(self, block: Block) -> None:
        """Near-tip: buffer the block, replay its certificates, and only
        advance the ledger once the block's leader certificate reaches the
        availability threshold among next-round certificates (or a later
        buffered block's leader links back to it) — sync/mod.rs:364-513."""
        if block.height <= self.ledger.latest_height() or \
                block.height in self.latest_block_responses:
            return
        if block.subdag is not None:
            self._replay_block_into_narwhal(block)
        latest = self.ledger.latest_height()
        self.latest_block_responses[block.height] = block
        for h in [h for h in self.latest_block_responses if h <= latest]:
            del self.latest_block_responses[h]

        # contiguous run from latest+1
        contiguous = []
        h = latest + 1
        while h in self.latest_block_responses:
            contiguous.append(self.latest_block_responses[h])
            h += 1
        for next_block in contiguous:
            if next_block.subdag is None:
                continue
            leader_cert = next_block.subdag.leader_certificate
            commit_round = leader_cert.round
            committee = self.ledger.committee_lookback_for(commit_round)
            certs = self.storage.get_certificates_for_round(commit_round + 1)
            authors = [c.author for c in certs
                       if leader_cert.id in c.batch_header.previous_certificate_ids]
            if not committee.is_availability(authors):
                log.debug("sync: availability threshold not reached for block %d "
                          "(round %d); buffering", next_block.height, commit_round)
                continue
            # walk back: earlier buffered blocks whose leader links forward
            blocks_to_add = [next_block]
            current_cert = leader_cert
            for height in range(next_block.height - 1,
                                self.ledger.latest_height(), -1):
                prev = self.latest_block_responses.get(height)
                if prev is None or prev.subdag is None:
                    break
                prev_cert = prev.subdag.leader_certificate
                if self._is_linked_in_storage(prev_cert, current_cert):
                    blocks_to_add.insert(0, prev)
                    current_cert = prev_cert
            for b in blocks_to_add:
                if b.height != self.ledger.latest_height() + 1:
                    continue
                self.sync_with_block(b)
                self.latest_block_responses.pop(b.height, None)

    def _is_linked_in_storage(self, earlier, later) -> bool:
        """Previous-certificate path check over Narwhal storage
        (sync/mod.rs is_linked)."""
        frontier = {later.id: later}
        for r in range(later.round, earlier.round, -1):
            nxt = {}
            for cert in frontier.values():
                for cid in cert.batch_header.previous_certificate_ids:
                    prev = self.storage.get_certificate(cid)
                    if prev is not None and prev.round == r - 1:
                        nxt[prev.id] = prev
            frontier = nxt
            if not frontier:
                return False
        return earlier.id in frontier
