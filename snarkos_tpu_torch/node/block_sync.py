"""Block sync engine (node/sync/src/block_sync.rs semantics).

Transport-generic (CommunicationService seam: works over the Router for
clients/provers and over the Gateway for validators — SURVEY.md §2.7).
Round-2 parity pass (VERDICT r1 item 5):

- pairwise common-ancestor map, maintained fork-detecting-upward on every
  locator update (block_sync.rs:391-439);
- consistent-sync-peer selection biased to the tallest peer whose cohort
  shares a common ancestor above canon (find_sync_peers_inner,
  block_sync.rs:718-760);
- per-height expected-hash requests built from the cohort's locators with
  redundancy escalation — 1 peer when the hash has REDUNDANCY_FACTOR
  confirmations, REDUNDANCY_FACTOR without, EXTRA_REDUNDANCY_FACTOR when
  peers disagree (construct_request, block_sync.rs:869-928);
- 600 s request timeout, incomplete-requests-only (block_sync.rs:48,672-716);
- response validation against the expected hash/previous-hash and the
  requested peer set; misbehaving peers lose all their outstanding
  requests (block_sync.rs:513-607).

The port of ``snarkos_tpu/node/block_sync.py``. Each block goes to the
ledger service's ``check_next_block`` and ``advance_to_next_block`` in the
loop's executor; over a ``CoreLedgerService`` whose ``Ledger`` is on the
card, that is the full block check on the card (the solutions' bindings
and one KZG batch). One rule differs from the reference, which logs every
exception of the check as an invalid block: a ``RuntimeError`` is how the
port reports a device fault (a CUDA error from a launch, a failed build,
no card: ``ops/_build.py``) and propagates out of ``try_block_sync`` /
``insert_block_responses``, the block left unapplied. The ledger refuses a
bad block with ``ValueError`` / ``KeyError`` and others; those are logged
and the height stays, as in the reference. The one ``RuntimeError`` the
check raises on a block's content, ``ledger.SRSTooSmall`` (a program whose
circuit needs a larger SRS than the node's artifact), is a refusal too.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Callable, Optional

from snarkos_tpu_torch.node import messages as msg
from snarkos_tpu_torch.node.ledger import SRSTooSmall
from snarkos_tpu_torch.node.types import Block

log = logging.getLogger(__name__)

# block_sync.rs:42-53 equivalents
REDUNDANCY_FACTOR = 1
EXTRA_REDUNDANCY_FACTOR = REDUNDANCY_FACTOR * 3
NUM_SYNC_CANDIDATE_PEERS = REDUNDANCY_FACTOR * 5
BLOCK_REQUEST_TIMEOUT_S = 600.0
MAX_BLOCK_REQUESTS = 50
MAX_BLOCKS_BEHIND = 1

# distinct from every real peer key (block_sync.rs DUMMY_SELF_IP)
DUMMY_SELF = ("<self>", 0)


def _pair(a, b):
    """Unordered peer pair key (helpers PeerPair)."""
    return (a, b) if repr(a) <= repr(b) else (b, a)


def _locator_map(locators: msg.BlockLocators) -> dict[int, bytes]:
    return dict(locators.checkpoints) | dict(locators.recents)


class BlockSync:
    def __init__(self, ledger_service, send_fn: Callable):
        """send_fn(peer, BlockRequest) — the communication seam."""
        self.ledger = ledger_service
        self.send_fn = send_fn
        self.peer_locators: dict = {}  # peer -> BlockLocators
        self.common_ancestors: dict = {}  # PeerPair -> height
        # height -> (expected_hash | None, expected_prev | None, sync peers left)
        self.requests: dict[int, tuple[Optional[bytes], Optional[bytes], set]] = {}
        self.responses: dict[int, Block] = {}
        self.request_times: dict[int, float] = {}
        self.lock = asyncio.Lock()

    # -- peer state (block_sync.rs:391-450) -----------------------------------
    def update_peer_locators(self, peer, locators: msg.BlockLocators) -> bool:
        """Returns False (peer should be dropped) on malformed locators."""
        if self.peer_locators.get(peer) == locators:
            return True
        if not locators.is_well_formed():
            return False
        self.peer_locators[peer] = locators

        # common ancestor with this node: iterate upward, stop at the FIRST
        # bifurcation (fork detection — block_sync.rs:402-416)
        ancestor = 0
        for height, hsh in sorted(_locator_map(locators).items()):
            canon_hash = self.ledger.get_block_hash(height)
            if canon_hash is None:
                continue
            if canon_hash == hsh:
                ancestor = height
            else:
                break
        self.common_ancestors[_pair(DUMMY_SELF, peer)] = ancestor

        # common ancestor with every other peer
        mine = _locator_map(locators)
        for other, other_loc in self.peer_locators.items():
            if other == peer:
                continue
            ancestor = 0
            for height, hsh in sorted(_locator_map(other_loc).items()):
                expected = mine.get(height)
                if expected is None:
                    continue
                if expected == hsh:
                    ancestor = height
                else:
                    break
            self.common_ancestors[_pair(peer, other)] = ancestor
        return True

    def remove_peer(self, peer) -> None:
        self.peer_locators.pop(peer, None)
        self._remove_block_requests_to_peer(peer)

    def greatest_peer_height(self) -> int:
        return max((l.latest_height for l in self.peer_locators.values()), default=0)

    def is_block_synced(self) -> bool:
        return self.num_blocks_behind() <= MAX_BLOCKS_BEHIND

    def num_blocks_behind(self) -> int:
        return max(0, self.greatest_peer_height() - self.ledger.latest_height())

    # -- sync-peer selection (block_sync.rs:718-760) --------------------------
    def find_sync_peers(self):
        """Returns ({peer: locators}, min_common_ancestor) or None."""
        canon = self.ledger.latest_height()
        candidates = sorted(
            ((p, l) for p, l in self.peer_locators.items() if l.latest_height > canon),
            key=lambda pl: -pl[1].latest_height,
        )[:NUM_SYNC_CANDIDATE_PEERS]
        if not candidates:
            return None
        threshold = min(len(candidates), REDUNDANCY_FACTOR)
        min_ca = 0
        sync_peers: dict = {}
        for i, (peer, locators) in enumerate(candidates):
            sync_peers = {peer: locators}
            min_ca = locators.latest_height
            for other, other_loc in candidates[i + 1:]:
                ca = self.common_ancestors.get(_pair(peer, other))
                if ca is not None and ca > canon and locators.is_consistent_with(other_loc):
                    min_ca = min(min_ca, ca)
                    sync_peers[other] = other_loc
            if min_ca > canon and len(sync_peers) >= threshold:
                break
        if min_ca <= canon or len(sync_peers) < threshold:
            return None
        return sync_peers, min_ca

    # -- the sync cycle (block_sync.rs:224-307) ------------------------------
    async def try_block_sync(self) -> None:
        async with self.lock:
            self._gc_timed_out_requests()
            await self._advance_with_responses()
            found = self.find_sync_peers()
            if found is None:
                return
            sync_peers, min_ca = found
            requests = self._construct_requests(sync_peers, min_ca)
            if not requests:
                return
            # chunk into <= DATA_BLOCKS_MAX spans with shared sync ips
            peers_list = list(sync_peers)
            i = 0
            while i < len(requests):
                chunk = requests[i:i + msg.DATA_BLOCKS_MAX]
                i += msg.DATA_BLOCKS_MAX
                start = chunk[0][0]
                end = chunk[-1][0] + 1
                num_ips = max(n for _, (_, _, n) in chunk)
                sync_ips = random.sample(peers_list, min(num_ips, len(peers_list)))
                for height, (hsh, prev, _) in chunk:
                    self.requests[height] = (hsh, prev, set(sync_ips))
                    self.request_times[height] = time.time()
                for peer in sync_ips:
                    self.send_fn(peer, msg.BlockRequest(start, end))

    def _check_block_request(self, height: int) -> bool:
        """True if a request for this height may be inserted."""
        return (
            height > self.ledger.latest_height()
            and height not in self.requests
            and height not in self.responses
            and height not in self.request_times
        )

    def _construct_requests(self, sync_peers: dict, min_ca: int):
        """(height, (hash|None, prev|None, num_sync_ips)) list
        (block_sync.rs:796-928)."""
        canon = self.ledger.latest_height()
        if min_ca <= canon:
            return []
        start = canon + 1
        end = min(min_ca + 1, start + MAX_BLOCK_REQUESTS * msg.DATA_BLOCKS_MAX)
        out = []
        max_num_ips = 1
        for height in range(start, end):
            if not self._check_block_request(height):
                if not out:
                    continue
                break
            hsh = None
            redundancy = 0
            prev = None
            honest = True
            for locators in sync_peers.values():
                lmap = _locator_map(locators)
                cand = lmap.get(height)
                if cand is not None:
                    if hsh is None:
                        hsh, redundancy = cand, 1
                    elif hsh == cand:
                        redundancy += 1
                    else:
                        hsh, redundancy, prev, honest = None, 0, None, False
                        break
                cand_prev = lmap.get(height - 1)
                if cand_prev is not None:
                    if prev is None:
                        prev = cand_prev
                    elif prev != cand_prev:
                        hsh, redundancy, prev, honest = None, 0, None, False
                        break
            if not honest:
                log.warning("sync: dishonest peer(s) detected preparing request %d", height)
                num_ips = EXTRA_REDUNDANCY_FACTOR
                if len(sync_peers) < num_ips:
                    break
            elif hsh is not None and redundancy >= REDUNDANCY_FACTOR:
                num_ips = 1
            else:
                num_ips = REDUNDANCY_FACTOR
            max_num_ips = max(max_num_ips, num_ips)
            out.append((height, (hsh, prev, num_ips)))
        # all requests in the batch share the largest sync-ip count
        return [(h, (hsh, prev, max_num_ips)) for h, (hsh, prev, _) in out]

    def _gc_timed_out_requests(self):
        """600 s timeout for INCOMPLETE requests; obsolete heights dropped
        (block_sync.rs:672-716)."""
        now = time.time()
        current = self.ledger.latest_height()
        for h in list(self.request_times):
            entry = self.requests.get(h)
            incomplete = entry is not None and bool(entry[2])
            timed_out = now - self.request_times[h] > BLOCK_REQUEST_TIMEOUT_S and incomplete
            obsolete = h <= current
            if timed_out or obsolete:
                self.requests.pop(h, None)
                self.responses.pop(h, None)
                self.request_times.pop(h, None)

    def _remove_block_requests_to_peer(self, peer):
        for h in list(self.requests):
            hsh, prev, ips = self.requests[h]
            ips.discard(peer)
            if not ips and h not in self.responses:
                self.requests.pop(h, None)
                self.request_times.pop(h, None)

    # -- responses (block_sync.rs:513-607) -----------------------------------
    def _check_block_response(self, peer, block: Block) -> Optional[str]:
        entry = self.requests.get(block.height)
        if entry is None:
            return f"the sync pool did not request block {block.height}"
        hsh, prev, ips = entry
        if hsh is not None and block.hash != hsh:
            return f"incorrect block hash for candidate block {block.height}"
        if prev is not None and block.previous_hash != prev:
            return f"incorrect previous hash in candidate block {block.height}"
        if peer not in ips:
            return f"block {block.height} was not requested from this peer"
        return None

    async def insert_block_responses(self, peer, blocks: list[Block]) -> None:
        async with self.lock:
            for block in blocks:
                err = self._check_block_response(peer, block)
                if err is not None:
                    log.warning("sync: bad response from %s: %s", peer, err)
                    self._remove_block_requests_to_peer(peer)
                    break
                self.requests[block.height][2].discard(peer)
                existing = self.responses.get(block.height)
                if existing is not None and existing.hash != block.hash:
                    # cross-peer mismatch: drop the response + this peer's requests
                    log.warning("sync: conflicting block %d from %s", block.height, peer)
                    self.responses.pop(block.height, None)
                    self._remove_block_requests_to_peer(peer)
                    break
                self.responses[block.height] = block
            await self._advance_with_responses()

    def _remove_block_response(self, height: int) -> Optional[Block]:
        """Pop the response if its request is complete (block_sync.rs:609-629)."""
        entry = self.requests.get(height)
        complete = entry is None or not entry[2]
        if not complete:
            return None
        self.requests.pop(height, None)
        self.request_times.pop(height, None)
        return self.responses.pop(height, None)

    async def _advance_with_responses(self) -> None:
        """Sequential check + advance (block_sync.rs:349-369)."""
        while True:
            next_height = self.ledger.latest_height() + 1
            block = self._remove_block_response(next_height)
            if block is None:
                return
            try:
                await asyncio.get_event_loop().run_in_executor(
                    None, self._check_and_advance, block
                )
            except Exception as exc:
                if isinstance(exc, RuntimeError) and not isinstance(exc, SRSTooSmall):
                    raise  # a device fault is no verdict on the block
                log.warning("sync: invalid block %d: %s", next_height, exc)
                return

    def _check_and_advance(self, block: Block):
        self.ledger.check_next_block(block)
        self.ledger.advance_to_next_block(block)
