"""CDN bootstrap: fast initial block download (node/cdn semantics).

Mirrors SURVEY.md §2.9 cdn row: blocks are fetched in 50-block bundle
files with bounded concurrency and retries, buffered, and applied
sequentially via ``advance_to_next_block``. The transport is pluggable:
``file://`` bases (a directory of bundle files, used by tests/devnets and
air-gapped hosts) work out of the box; ``http(s)://`` bases use urllib
when egress exists. Disabled for dev/prover nodes by the CLI, like the
reference (cli/src/commands/start.rs:261-291).

The port of ``snarkos_tpu/node/cdn.py``: a bundle is the JAX package's
bytes. One rule differs: the reference logs every exception of a block's
check as an invalid block and stops the bootstrap there; a device fault
(``ledger.is_device_fault``: a ``RuntimeError`` from the check on the card)
propagates to the caller instead, the block left unapplied.
"""

from __future__ import annotations

import asyncio
import logging
import os
from urllib.parse import urlparse

from snarkos_tpu_torch.node.codec import Reader, Writer
from snarkos_tpu_torch.node.ledger import is_device_fault
from snarkos_tpu_torch.node.types import Block

log = logging.getLogger(__name__)

BLOCKS_PER_FILE = 50
MAX_CONCURRENT_REQUESTS = 16
MAX_RETRIES = 10
MAX_PENDING_BLOCKS = 1600


def bundle_name(start_height: int) -> str:
    return f"block.{start_height}.{start_height + BLOCKS_PER_FILE}.bundle"


def write_bundle(path: str, blocks: list[Block]) -> None:
    """Serialize a 50-block bundle file (used to publish a CDN snapshot)."""
    w = Writer().u32(len(blocks))
    for b in blocks:
        w.bytes_var(b.to_bytes())
    with open(path, "wb") as f:
        f.write(w.out())


def read_bundle(data: bytes) -> list[Block]:
    r = Reader(data)
    blocks = [Block.from_bytes(r.bytes_var()) for _ in range(r.u32())]
    r.expect_done()
    return blocks


async def _fetch(base_url: str, name: str) -> bytes | None:
    parsed = urlparse(base_url)
    if parsed.scheme in ("", "file"):
        path = os.path.join(parsed.path or base_url, name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()
    # http(s) — only usable where egress exists
    import urllib.request

    def blocking():
        try:
            with urllib.request.urlopen(f"{base_url.rstrip('/')}/{name}", timeout=30) as r:
                return r.read()
        except Exception:
            return None

    return await asyncio.get_event_loop().run_in_executor(None, blocking)


async def cdn_height(base_url: str) -> int:
    """Probe the highest complete bundle available."""
    height = 0
    while True:
        data = await _fetch(base_url, bundle_name(height))
        if data is None:
            return height
        height += BLOCKS_PER_FILE


async def sync_ledger_with_cdn(base_url: str, ledger_service) -> int:
    """Download + apply bundles from the CDN until exhausted; returns the
    final ledger height (blocks.rs:56-210 equivalent)."""
    start = (ledger_service.latest_height() // BLOCKS_PER_FILE) * BLOCKS_PER_FILE
    applied = ledger_service.latest_height()
    sem = asyncio.Semaphore(MAX_CONCURRENT_REQUESTS)
    pending: dict[int, list[Block]] = {}

    async def fetch_bundle(h):
        async with sem:
            for attempt in range(MAX_RETRIES):
                data = await _fetch(base_url, bundle_name(h))
                if data is not None:
                    try:
                        pending[h] = read_bundle(data)
                        return True
                    except Exception as exc:
                        log.warning("cdn: corrupt bundle at %d: %s", h, exc)
                await asyncio.sleep(0.1 * (attempt + 1))
            return False

    height = start
    while True:
        # fetch a window of bundles concurrently
        window = [height + i * BLOCKS_PER_FILE for i in range(MAX_CONCURRENT_REQUESTS)]
        results = await asyncio.gather(*(fetch_bundle(h) for h in window))
        if not any(results):
            break
        # apply in order
        for h in window:
            blocks = pending.pop(h, None)
            if blocks is None:
                break
            for block in sorted(blocks, key=lambda b: b.height):
                if block.height != ledger_service.latest_height() + 1:
                    continue
                try:
                    ledger_service.check_next_block(block)
                    ledger_service.advance_to_next_block(block)
                    applied = block.height
                except Exception as exc:
                    if is_device_fault(exc):
                        raise
                    log.warning("cdn: invalid block %d: %s", block.height, exc)
                    return applied
        if len(pending) > MAX_PENDING_BLOCKS // BLOCKS_PER_FILE:
            pending.clear()
        height += MAX_CONCURRENT_REQUESTS * BLOCKS_PER_FILE
        if not all(results):
            break
    return applied
