"""The port's network planes in the CPU tests and in chip_smoke.py: a time
limit for a test's event loop, polls in place of fixed sleeps, the dev
accounts and committee cached, and the server half of a block sync: a
``Router`` that answers ``BlockRequest``s from a chain
(``Client._serve_block_request``) and announces its block locators with a
``Ping``. The client half is the node's own Client role
(``roles.Client``). The message module is a parameter, so that a server
may be the JAX package's router in the tests that hold the port against
it. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import sys

from snarkos_tpu_torch.node import cli, messages as msg
from snarkos_tpu_torch.node.types import Committee
from snarkos_tpu_torch.utils import native


@functools.lru_cache(maxsize=None)
def account(index: int):
    """The node CLI's ``dev_account(index)``, derived once a process (a
    pure-Python scalar multiplication, ~0.03 s)."""
    return cli.dev_account(index)


@functools.lru_cache(maxsize=None)
def committee(num_validators: int) -> Committee:
    """The node CLI's ``dev_committee(num_validators)``, built once a process."""
    return cli.dev_committee(num_validators)


def handshake_nonce(k: int) -> int:
    """``secrets.randbits(k)`` fixed for the byte-for-byte tests: a function of
    the handshaking node's account, read from its ``_handshake`` frame, so
    that the two ends draw different nonces and either package draws the
    same one in a role."""
    node = sys._getframe(1).f_locals["self"]
    digest = hashlib.sha256(b"handshake nonce" + node.account.address.encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << k) - 1)


def run(coro, limit: float = 10.0):
    """Run ``coro`` on a new event loop under a time limit. The host engines
    are loaded first: in a fresh checkout the first load builds them (~20 s
    of g++), which would otherwise block the loop inside the limit."""
    native.load_engines()
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
