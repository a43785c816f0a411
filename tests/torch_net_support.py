"""The port's network planes in the CPU tests and in chip_smoke.py's block
sync phase: a time limit for a test's event loop, polls in place of fixed
sleeps, and the two halves of a block sync over ``Router``s wired as the
node's Client role wires them (``snarkos_tpu/node/roles.py`` ``Client``:
``_wire_router``, ``_serve_block_request``, ``_on_block_response`` and the
body of ``_sync_loop``), for as long as the roles are not ported.

A server answers ``BlockRequest``s from a chain and announces its block
locators with a ``Ping``; a ``SyncClient`` keeps a ``BlockSync`` over the
ledger service it is given and feeds it each ``BlockResponse``. Over a
``CoreLedgerService`` whose ``Ledger`` is on the card, each synced block
goes through the full block check there. The message module is a
parameter, so that a server may be the JAX package's router in the tests
that hold the port against it. Nothing here imports JAX or the JAX
package.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import sys

from snarkos_tpu_torch.node import messages as msg
from snarkos_tpu_torch.node.block_sync import BlockSync
from snarkos_tpu_torch.node.router import Router
from snarkos_tpu_torch.node.types import Committee, point_to_address

from torch_bft_support import dev_account


@functools.lru_cache(maxsize=None)
def account(index: int):
    """``torch_bft_support.dev_account(index)``, derived once a process (a
    pure-Python scalar multiplication, ~0.03 s)."""
    return dev_account(index)


@functools.lru_cache(maxsize=None)
def committee(num_validators: int) -> Committee:
    """``torch_bft_support.dev_committee(num_validators)`` over ``account``."""
    return Committee.new(1, {point_to_address(account(i).pk): 100
                             for i in range(num_validators)})


def handshake_nonce(k: int) -> int:
    """``secrets.randbits(k)`` fixed for the byte-for-byte tests: a function of
    the handshaking node's account, read from its ``_handshake`` frame, so
    that the two ends draw different nonces and either package draws the
    same one in a role."""
    node = sys._getframe(1).f_locals["self"]
    digest = hashlib.sha256(b"handshake nonce" + node.account.address.encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << k) - 1)


def run(coro, limit: float = 10.0):
    """Run ``coro`` on a new event loop under a time limit."""
    return asyncio.run(asyncio.wait_for(coro, limit))


async def until(cond, limit: float = 3.0, step: float = 0.005) -> bool:
    """Poll ``cond()`` until it holds (True) or ``limit`` seconds pass (False)."""
    loop = asyncio.get_running_loop()
    end = loop.time() + limit
    while not cond():
        if loop.time() > end:
            return False
        await asyncio.sleep(step)
    return True


async def closed_by_peer(reader: asyncio.StreamReader, limit: float = 3.0) -> bool:
    """True once the other end has closed the socket (EOF or a reset),
    False if it is still open after ``limit`` seconds."""
    try:
        while await asyncio.wait_for(reader.read(1 << 16), limit):
            pass
    except asyncio.TimeoutError:
        return False
    except ConnectionError:
        pass
    return True


def serve_blocks(router, get_block, latest_height, messages=msg) -> None:
    """Answer ``BlockRequest``s on ``router`` from ``get_block(height)`` up to
    ``latest_height()`` (``Client._serve_block_request``)."""

    async def serve(addr, peer, req):
        top = min(req.end_height, latest_height() + 1)
        blocks = tuple(get_block(h) for h in range(req.start_height, top))
        router.send(addr, messages.BlockResponse(req, blocks))

    router.handlers[messages.BlockRequest] = serve


def announce(router, addr, locators, messages=msg) -> None:
    """Send the peer at ``addr`` a ``Ping`` with ``locators`` (the role's
    heartbeat ping)."""
    router.send(addr, messages.Ping(messages.VERSION, messages.NodeType.CLIENT, locators))


class SyncClient:
    """A ``Router`` and a ``BlockSync`` over ``service``: the requests go out
    through the router, each ``BlockResponse`` to ``insert_block_responses``.
    What a response's insertion raises is kept in ``errors`` (the router's
    handler task would only log it) and raised again by ``sync_to``."""

    def __init__(self, account, service, genesis_hash: bytes,
                 node_type: int = msg.NodeType.CLIENT):
        self.service = service
        self.router = Router(account, node_type, genesis_hash)
        self.router.latest_height_fn = service.latest_height
        self.sync = BlockSync(service, self.router.send)
        self.errors: list = []
        self.responses = 0
        self.router.handlers[msg.BlockResponse] = self._on_response

    async def _on_response(self, addr, peer, resp):
        try:
            resp.ensure_well_formed()
        except ValueError:
            self.sync.remove_peer(addr)
            await self.router.tcp.disconnect(addr)
            return
        try:
            await self.sync.insert_block_responses(addr, list(resp.blocks))
        except Exception as exc:
            self.errors.append(exc)
            raise
        finally:
            self.responses += 1

    def take_locators(self) -> None:
        """Hand the sync every connected peer's announced locators."""
        for addr, peer in list(self.router.peers.items()):
            if peer.block_locators is not None:
                self.sync.update_peer_locators(addr, peer.block_locators)

    async def step(self) -> None:
        """One round of the role's sync loop, without its 5 s sleep."""
        if self.errors:
            raise self.errors[0]
        self.take_locators()
        await self.sync.try_block_sync()

    async def sync_to(self, height: int, limit: float, step_s: float = 0.01) -> None:
        """Run the sync loop until the ledger reaches ``height``; raise what a
        response raised, or TimeoutError after ``limit`` seconds."""
        loop = asyncio.get_running_loop()
        end = loop.time() + limit
        while self.service.latest_height() < height:
            await self.step()
            if loop.time() > end:
                raise TimeoutError(f"the sync reached height {self.service.latest_height()} "
                                   f"of {height} in {limit} s")
            await asyncio.sleep(step_s)
        if self.errors:
            raise self.errors[0]
