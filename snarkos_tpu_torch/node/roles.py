"""Node roles: Validator, Client, Prover (node/src semantics, SURVEY.md §2.8).

Each role wires the planes together:
- Validator: ledger -> CoreLedgerService -> Consensus over the Gateway
  plane + public Router plane (serves blocks/puzzle state, routes
  solutions/transactions into consensus and re-propagates).
- Client: ledger + BlockSync over the Router, verifies + re-propagates
  solutions, serves block/puzzle requests.
- Prover: no ledger; puzzle loops on the card; broadcasts solutions; pulls
  epoch state with PuzzleRequest each heartbeat.

The port of ``snarkos_tpu/node/roles.py``. Two rules differ from it:

- **The device.** Each role takes ``device`` (None: the card) and resolves
  it first in ``__init__`` (``_build.resolve_device``), so that without a
  card the constructor raises "no CUDA device" before a ledger is built or
  a socket bound. The Validator and the Client run their ledger there; the
  Prover builds its puzzle there in ``start()``, before its loop, so that a
  failed build is raised to the caller; the dev transactions are created
  there. Nothing falls back to the CPU.
- **The fault rule.** The reference logs and carries on past every
  exception of its sync loops, its block and ping handlers, its dev
  transaction loop and its puzzle loop, and so does its consensus core in
  the mempool drain, the proposal re-checks and a commit's block advance
  (the Validator passes ``on_fault`` to ``Consensus``). The port reports
  a device fault as a ``RuntimeError`` (``ledger.is_device_fault``): at
  each of those places it stops the node instead. The error is kept as
  ``fault``, logged at ERROR with its traceback, the role's tasks end and
  ``shut_down`` runs (``halted`` is set when it is done). What the reference refuses on
  content (``ValueError``, ``KeyError``, ``ledger.SRSTooSmall``) keeps the
  reference's handling.

``SYNC_INTERVAL_S`` is the reference's 5-second sleep between sync rounds,
``PUZZLE_REQUEST_S`` its Prover's 5 seconds between ``PuzzleRequest``s.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import os
from typing import Optional

from snarkos_tpu_torch.node import events as ev, messages as msg, metrics
from snarkos_tpu_torch.node.block_sync import BlockSync
from snarkos_tpu_torch.node.consensus import Consensus
from snarkos_tpu_torch.node.gateway import Gateway
from snarkos_tpu_torch.node.ledger import (
    CoreLedgerService,
    Ledger,
    ProverLedgerService,
    TranslucentLedgerService,
    is_device_fault,
)
from snarkos_tpu_torch.node.router import Router
from snarkos_tpu_torch.node.types import Block, Committee, Solution
from snarkos_tpu_torch.ops import _build
from snarkos_tpu_torch.utils import native

log = logging.getLogger(__name__)

SYNC_INTERVAL_S = 5.0
PUZZLE_REQUEST_S = 5.0


class _BaseNode:
    account = None
    router: Router = None
    fault: Optional[BaseException] = None

    def _init_node(self, device) -> None:
        self.device = _build.resolve_device(device)
        # the host engines (pairing, G1, Poseidon) build and load before a
        # ledger or a socket exists: a host that cannot build them stops here
        native.load_engines()
        self._tasks: list[asyncio.Task] = []
        self.halted = asyncio.Event()
        self._closing: Optional[asyncio.Task] = None

    def _halt_on_fault(self, exc: BaseException, where: str) -> bool:
        """Stop the node if ``exc`` is a device fault (True); else False, and
        the caller keeps the reference's handling."""
        if not is_device_fault(exc):
            return False
        if self.fault is None:
            self.fault = exc
            log.error("%s: device fault, stopping the node", where, exc_info=exc)
        if self._closing is None:
            self._closing = asyncio.get_running_loop().create_task(self._close())
        return True

    async def shut_down(self):
        """Stop the node once; a later call waits for the first."""
        if self._closing is None:
            self._closing = asyncio.get_running_loop().create_task(self._close())
        await asyncio.shield(self._closing)

    async def _close(self):
        try:
            await self._shut_down()
        finally:
            self.halted.set()

    async def _shut_down(self):
        raise NotImplementedError


class Validator(_BaseNode):
    """node/src/validator/mod.rs:57-162 wiring order."""

    def __init__(self, account, committee: Committee, *,
                 node_ip: str = "127.0.0.1", node_port: int = 0,
                 bft_port: int = 0, rest_port: Optional[int] = None,
                 storage_path: Optional[str] = None,
                 trusted_peers: tuple = (), trusted_validators: tuple = (),
                 translucent: bool = False, dev_tx_interval: Optional[float] = None,
                 device=None):
        self._init_node(device)
        self.account = account
        self.ledger = Ledger(committee, storage_path, device=self.device)
        svc_cls = TranslucentLedgerService if translucent else CoreLedgerService
        self.ledger_service = svc_cls(self.ledger)
        self.gateway = Gateway(account, self.ledger_service, ip=node_ip,
                               port=bft_port, trusted_validators=trusted_validators)
        self.consensus = Consensus(account, self.ledger_service, self.gateway,
                                   on_block=self._on_block_committed,
                                   on_fault=self._halt_on_fault)
        self.router = Router(
            account, msg.NodeType.VALIDATOR, self.ledger.blocks[0].hash,
            ip=node_ip, port=node_port, trusted_peers=trusted_peers,
            max_peers=200,
        )
        self.router.latest_height_fn = lambda: self.ledger.latest_height
        self.block_sync = BlockSync(self.ledger_service, self._send_block_request)
        self.rest_port = rest_port
        self.rest = None
        self.dev_tx_interval = dev_tx_interval
        self.proposal_cache_path = (
            os.path.join(os.path.dirname(storage_path), ".current-proposal-cache")
            if storage_path else None
        )
        self._wire_gateway()
        self._wire_router()

    # -- gateway wiring ------------------------------------------------------
    def _wire_gateway(self):
        g, p = self.gateway, self.consensus.primary
        g.on_batch_propose = p.process_batch_propose
        g.on_batch_signature = self._on_batch_signature
        g.on_batch_certified = p.process_batch_certified
        g.on_certificate_request = p.serve_certificate_request
        g.on_certificate_response = p.process_certificate_response
        # route transmission events to their assigned worker by sha256d
        # partition (gateway.rs assign_to_worker; partition.rs:32-67)
        g.on_transmission_request = lambda a, e: p.worker_for(
            e.transmission_id).serve_transmission_request(a, e)
        g.on_transmission_response = lambda e: p.worker_for(
            e.transmission_id).process_transmission_response(e)
        g.on_worker_ping = lambda a, e: p.process_worker_ping(a, e)
        g.on_block_request = self._serve_gateway_block_request
        g.on_block_response = self._on_gateway_block_response
        g.on_primary_ping = self._on_primary_ping
        self._gateway_peer_heights = {}

    async def _on_batch_signature(self, addr, event, validator):
        await self.consensus.primary.process_batch_signature(addr, event, validator)

    async def _serve_gateway_block_request(self, addr, req: ev.BlockRequest):
        blocks = self._blocks_for_request(req)
        self.gateway.send(addr, msg.BlockResponse(req, tuple(blocks)))

    async def _on_gateway_block_response(self, addr, resp: msg.BlockResponse):
        """Deep-behind (no-BFT fast path) vs near-tip (subdag-validated)
        distinction — node/bft/src/sync/mod.rs:299-513."""
        loop = asyncio.get_event_loop()
        tip = max(self._gateway_peer_heights.values(), default=0)
        was_deep = self.consensus.is_deep_behind(tip)
        for block in sorted(resp.blocks, key=lambda b: b.height):
            try:
                if self.consensus.is_deep_behind(tip):
                    if block.height == self.ledger.latest_height + 1:
                        await loop.run_in_executor(
                            None, self.consensus.sync_ledger_with_block_without_bft,
                            block)
                else:
                    if was_deep:
                        # crossed into GC range: replay the ledger tail into
                        # Narwhal before validating near-tip blocks
                        self.consensus.sync_storage_with_ledger_at_bootup()
                        was_deep = False
                    await loop.run_in_executor(
                        None, self.consensus.sync_storage_with_block, block)
            except Exception as exc:
                if self._halt_on_fault(exc, "gateway sync"):
                    return
                log.warning("gateway sync: invalid block %d: %s", block.height, exc)
                return

    async def _on_primary_ping(self, addr, ping):
        self._gateway_peer_heights[addr] = ping.block_height
        if ping.primary_certificate is not None:
            try:
                await self.consensus.primary.process_batch_certified(
                    addr, ev.BatchCertified(ping.primary_certificate)
                )
            except Exception as exc:
                self._halt_on_fault(exc, "primary ping")

    def _send_block_request(self, peer, req: msg.BlockRequest):
        self.gateway.send(peer, req)

    # -- router wiring (validator/router.rs:174-301) -------------------------
    def _wire_router(self):
        r = self.router
        r.handlers[msg.BlockRequest] = self._serve_block_request
        r.handlers[msg.PuzzleRequest] = self._serve_puzzle_request
        r.handlers[msg.UnconfirmedSolution] = self._on_unconfirmed_solution
        r.handlers[msg.UnconfirmedTransaction] = self._on_unconfirmed_transaction
        r.handlers["ping_builder"] = self._build_ping

    def _build_ping(self):
        return msg.Ping(msg.VERSION, msg.NodeType.VALIDATOR,
                        self.ledger.latest_block_locators())

    def _blocks_for_request(self, req) -> list[Block]:
        out = []
        for h in range(req.start_height, min(req.end_height, self.ledger.latest_height + 1)):
            if self.ledger.contains_block_height(h):
                out.append(self.ledger.get_block(h))
        return out

    async def _serve_block_request(self, addr, peer, req: msg.BlockRequest):
        self.router.send(addr, msg.BlockResponse(req, tuple(self._blocks_for_request(req))))

    async def _serve_puzzle_request(self, addr, peer, req: msg.PuzzleRequest):
        self.router.send(addr, msg.PuzzleResponse(
            self.ledger.latest_epoch_hash, self.ledger.latest_height,
            self.ledger.latest_proof_target,
        ))

    async def _on_unconfirmed_solution(self, addr, peer, m: msg.UnconfirmedSolution):
        sol = m.deserialize()
        try:
            await self.consensus.add_unconfirmed_solution(sol)
        except ValueError:
            return
        self.router.propagate(m, exclude={addr})

    async def _on_unconfirmed_transaction(self, addr, peer, m: msg.UnconfirmedTransaction):
        tx = m.deserialize()
        try:
            await self.consensus.add_unconfirmed_transaction(tx)
        except ValueError:
            return
        self.router.propagate(m, exclude={addr})

    async def _on_block_committed(self, block: Block):
        pass  # hook for metrics / gossip

    # -- lifecycle -----------------------------------------------------------
    async def start(self):
        if self.proposal_cache_path:
            self.consensus.primary.load_proposal_cache(self.proposal_cache_path)
        await self.gateway.run()
        await self.consensus.run()
        await self.router.run()
        if self.rest_port is not None:
            from snarkos_tpu_torch.node.rest import Rest

            self.rest = Rest(self, port=self.rest_port)
            await self.rest.start()
        self._tasks.append(asyncio.create_task(self._sync_loop()))
        if self.dev_tx_interval:
            self._tasks.append(asyncio.create_task(self._dev_tx_loop()))

    async def _sync_loop(self):
        while True:
            try:
                await asyncio.sleep(SYNC_INTERVAL_S)
                # gateway-plane catch-up: if peers report taller chains,
                # request the next window of blocks from the tallest peer
                if self._gateway_peer_heights:
                    peer, height = max(self._gateway_peer_heights.items(),
                                       key=lambda kv: kv[1])
                    ours = self.ledger.latest_height
                    if height > ours:
                        self.gateway.send(peer, msg.BlockRequest(
                            ours + 1, min(height + 1, ours + 1 + msg.DATA_BLOCKS_MAX)))
                await self.block_sync.try_block_sync()
            except asyncio.CancelledError:
                return
            except Exception as exc:
                if self._halt_on_fault(exc, "validator sync loop"):
                    return
                log.debug("validator sync loop: %s", exc)

    async def _dev_tx_loop(self):
        """Dev transaction generator (validator/mod.rs:346-412), each
        transaction created on the validator's device."""
        from snarkos_tpu_torch.node.ledger import create_transaction

        i = 0
        while True:
            try:
                await asyncio.sleep(self.dev_tx_interval)
                payload = f"dev-transfer-{self.account.address[:16]}-{i}".encode()
                tx = await asyncio.get_event_loop().run_in_executor(
                    None, functools.partial(create_transaction, payload, device=self.device)
                )
                i += 1
                await self.consensus.add_unconfirmed_transaction(tx)
                self.router.propagate(
                    msg.UnconfirmedTransaction(tx.id, tx.to_bytes()), exclude=set()
                )
            except asyncio.CancelledError:
                return
            except Exception as exc:
                if self._halt_on_fault(exc, "dev tx loop"):
                    return
                log.debug("dev tx loop: %s", exc)

    async def _shut_down(self):
        if self.proposal_cache_path:
            try:
                self.consensus.primary.store_proposal_cache(self.proposal_cache_path)
            except Exception as exc:
                log.debug("failed to store proposal cache: %s", exc)
        for t in self._tasks:
            t.cancel()
        if self.rest is not None:
            await self.rest.stop()
        await self.consensus.shut_down()
        await self.gateway.shut_down()
        await self.router.shut_down()


class Client(_BaseNode):
    """node/src/client/mod.rs:57-190."""

    def __init__(self, account, committee: Committee, *,
                 node_ip: str = "127.0.0.1", node_port: int = 0,
                 rest_port: Optional[int] = None,
                 storage_path: Optional[str] = None, trusted_peers: tuple = (),
                 device=None):
        self._init_node(device)
        self.account = account
        self.ledger = Ledger(committee, storage_path, device=self.device)
        self.ledger_service = CoreLedgerService(self.ledger)
        self.router = Router(
            account, msg.NodeType.CLIENT, self.ledger.blocks[0].hash,
            ip=node_ip, port=node_port, trusted_peers=trusted_peers,
        )
        self.router.latest_height_fn = lambda: self.ledger.latest_height
        self.block_sync = BlockSync(self.ledger_service, self._send_block_request)
        self.rest_port = rest_port
        self.rest = None
        self.consensus = None
        self._wire_router()

    def _send_block_request(self, peer, req):
        self.router.send(peer, req)

    def _wire_router(self):
        r = self.router
        r.handlers[msg.BlockRequest] = self._serve_block_request
        r.handlers[msg.BlockResponse] = self._on_block_response
        r.handlers[msg.PuzzleRequest] = self._serve_puzzle_request
        r.handlers[msg.UnconfirmedSolution] = self._on_unconfirmed_solution
        r.handlers[msg.UnconfirmedTransaction] = self._on_unconfirmed_transaction
        r.handlers["ping_builder"] = lambda: msg.Ping(
            msg.VERSION, msg.NodeType.CLIENT, self.ledger.latest_block_locators()
        )

    async def _serve_block_request(self, addr, peer, req):
        blocks = []
        for h in range(req.start_height, min(req.end_height, self.ledger.latest_height + 1)):
            blocks.append(self.ledger.get_block(h))
        self.router.send(addr, msg.BlockResponse(req, tuple(blocks)))

    async def _on_block_response(self, addr, peer, resp: msg.BlockResponse):
        try:
            resp.ensure_well_formed()
        except ValueError as exc:
            log.warning("malformed block response from %s: %s", addr, exc)
            self.block_sync.remove_peer(addr)
            await self.router.tcp.disconnect(addr)
            return
        # what the sync lets through is a device fault: the router's handler
        # task would log it at debug level only
        try:
            await self.block_sync.insert_block_responses(addr, list(resp.blocks))
        except RuntimeError as exc:
            if not self._halt_on_fault(exc, "client sync"):
                raise

    async def _serve_puzzle_request(self, addr, peer, req):
        self.router.send(addr, msg.PuzzleResponse(
            self.ledger.latest_epoch_hash, self.ledger.latest_height,
            self.ledger.latest_proof_target,
        ))

    async def _on_unconfirmed_solution(self, addr, peer, m: msg.UnconfirmedSolution):
        # Verification runs off the event loop (reference uses spawn_blocking,
        # ledger.rs:312): a slow verify must not stall frame decoding for
        # every connected peer.
        sol = m.deserialize()
        try:
            await asyncio.get_event_loop().run_in_executor(
                None, self.ledger_service.check_solution_basic, sol
            )
        except ValueError:
            return
        except RuntimeError as exc:
            if self._halt_on_fault(exc, "client solution check"):
                return
            raise
        self.router.propagate(m, exclude={addr})

    async def _on_unconfirmed_transaction(self, addr, peer, m: msg.UnconfirmedTransaction):
        # Off-loop for the same reason (reference ledger.rs:341).
        tx = m.deserialize()
        try:
            await asyncio.get_event_loop().run_in_executor(
                None, self.ledger_service.check_transaction_basic, tx
            )
        except ValueError:
            return
        except RuntimeError as exc:
            if self._halt_on_fault(exc, "client transaction check"):
                return
            raise
        self.router.propagate(m, exclude={addr})

    async def start(self):
        await self.router.run()
        if self.rest_port is not None:
            from snarkos_tpu_torch.node.rest import Rest

            self.rest = Rest(self, port=self.rest_port)
            await self.rest.start()
        self._tasks.append(asyncio.create_task(self._sync_loop()))

    async def _sync_loop(self):
        while True:
            try:
                await asyncio.sleep(SYNC_INTERVAL_S)
                for addr, peer in self.router.peers.items():
                    if peer.block_locators is not None:
                        self.block_sync.update_peer_locators(addr, peer.block_locators)
                await self.block_sync.try_block_sync()
            except asyncio.CancelledError:
                return
            except Exception as exc:
                if self._halt_on_fault(exc, "client sync loop"):
                    return
                log.debug("client sync loop: %s", exc)

    async def _shut_down(self):
        for t in self._tasks:
            t.cancel()
        if self.rest is not None:
            await self.rest.stop()
        await self.router.shut_down()


class Prover(_BaseNode):
    """node/src/prover/mod.rs:63-275: puzzle loops on the card."""

    def __init__(self, account, genesis_hash: bytes, *,
                 node_ip: str = "127.0.0.1", node_port: int = 0,
                 trusted_peers: tuple = (), log_degree: Optional[int] = None,
                 max_iterations: Optional[int] = None, nonce_batch: int = 8,
                 device=None):
        self._init_node(device)
        self.account = account
        self.nonce_batch = max(1, nonce_batch)
        self.ledger_service = ProverLedgerService()
        self.router = Router(
            account, msg.NodeType.PROVER, genesis_hash,
            ip=node_ip, port=node_port, trusted_peers=trusted_peers,
        )
        self.latest_epoch_hash: Optional[bytes] = None
        self.latest_proof_target = 1 << 8
        self.log_degree = log_degree
        self.max_iterations = max_iterations
        self.puzzle = None
        self.solutions_found = 0
        self.iterations = 0
        self._wire_router()

    def _wire_router(self):
        r = self.router
        r.handlers[msg.PuzzleResponse] = self._on_puzzle_response
        r.handlers["ping_builder"] = lambda: msg.Ping(msg.VERSION, msg.NodeType.PROVER, None)

    async def _on_puzzle_response(self, addr, peer, resp: msg.PuzzleResponse):
        self.latest_epoch_hash = resp.epoch_hash
        self.latest_proof_target = resp.proof_target

    async def start(self):
        from snarkos_tpu_torch.ops.puzzle import global_puzzle

        # built here, not in the task: a failed build reaches the caller
        self.puzzle = global_puzzle(self.log_degree, device=self.device)
        await self.router.run()
        self._tasks.append(asyncio.create_task(self._puzzle_request_loop()))
        self._tasks.append(asyncio.create_task(self._puzzle_loop()))

    async def _puzzle_request_loop(self):
        while True:
            try:
                await asyncio.sleep(PUZZLE_REQUEST_S)
                peers = self.router.connected_peers()
                if peers:
                    self.router.send(peers[0], msg.PuzzleRequest())
            except asyncio.CancelledError:
                return

    async def _puzzle_loop(self):
        """Batched multi-nonce proving: B nonces per device dispatch (the
        card's analogue of the reference's clamp(cores-2, 1, 6) parallel CPU
        instances, node/src/prover/mod.rs:122-148)."""
        puzzle = self.puzzle
        nonce = int.from_bytes(os.urandom(8), "little")
        batch = self.nonce_batch
        while True:
            try:
                if self.latest_epoch_hash is None:
                    await asyncio.sleep(1.0)
                    continue
                if self.max_iterations and self.iterations >= self.max_iterations:
                    return
                epoch_hash = self.latest_epoch_hash
                target = self.latest_proof_target
                nonces = [(nonce + 1 + i) & ((1 << 64) - 1) for i in range(batch)]
                nonce = nonces[-1]
                self.iterations += len(nonces)
                metrics.update_gauge("prover_iterations", self.iterations)
                # keep (nonce -> solution) so the Solution carries ITS nonce
                found = await asyncio.get_event_loop().run_in_executor(
                    None, self._prove_batch_indexed, puzzle, epoch_hash,
                    nonces, target,
                )
                for n, sol_data in found:
                    self.solutions_found += 1
                    metrics.update_gauge("prover_solutions_found", self.solutions_found)
                    sol = Solution(
                        epoch_hash=epoch_hash, address=self.account.address,
                        nonce=n, commitment=sol_data.commitment,
                        eval_y=sol_data.eval_y, witness=sol_data.witness,
                    )
                    self.router.propagate(
                        msg.UnconfirmedSolution(sol.id, sol.to_bytes()), exclude=set()
                    )
                    log.info("prover: found solution id=%x (target %d)",
                             sol_data.solution_id, target)
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                return
            except Exception as exc:
                if self._halt_on_fault(exc, "puzzle loop"):
                    return
                log.debug("puzzle loop error: %s", exc)
                await asyncio.sleep(0.5)

    def _prove_batch_indexed(self, puzzle, epoch_hash, nonces, target):
        out = []
        sols = puzzle.prove_batch(epoch_hash, self.account.address, nonces, None)
        for n, sol in zip(nonces, sols):
            if target is None or puzzle.passes_target(sol.solution_id, target):
                out.append((n, sol))
        return out

    async def _shut_down(self):
        for t in self._tasks:
            t.cancel()
        await self.router.shut_down()
