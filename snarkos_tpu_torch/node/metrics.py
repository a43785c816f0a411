"""Metrics registry + Prometheus text exposition (node/metrics semantics).

Mirrors SURVEY.md §6.5: counters/gauges/histograms registered up front
(BFT round/height/leader/commit latency, block composition, mempool
depth, connection counts), updated from consensus/router hot paths, and
served as Prometheus text format on an HTTP port (default 9000).

The port of ``snarkos_tpu/node/metrics.py``.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import defaultdict

_LOCK = threading.Lock()
_COUNTERS: dict[str, float] = defaultdict(float)
_GAUGES: dict[str, float] = {}
_HISTOGRAMS: dict[str, list] = defaultdict(list)

# names.rs equivalents
COUNTER_NAMES = [
    "bft_process_batch_propose_total",
    "bft_process_batch_certified_total",
]
GAUGE_NAMES = [
    "bft_current_round",
    "bft_last_committed_round",
    "bft_leader_elected",
    "blocks_height",
    "blocks_transmissions",
    "blocks_solutions",
    "blocks_transactions",
    "consensus_committed_certificates",
    "consensus_last_committed_round",
    "mempool_solutions",
    "mempool_transactions",
    "mempool_ready_transmissions",
    "router_connected_peers",
    "router_candidate_peers",
    "router_restricted_peers",
    "gateway_connected_validators",
    "tcp_open_connections",
    "prover_solutions_found",
    "prover_iterations",
]
HISTOGRAM_NAMES = [
    "consensus_commit_latency_seconds",
    "consensus_block_advance_seconds",
    "bft_proposal_quorum_seconds",
]


def increment_counter(name: str, value: float = 1.0) -> None:
    with _LOCK:
        _COUNTERS[name] += value


def update_gauge(name: str, value: float) -> None:
    with _LOCK:
        _GAUGES[name] = value


def observe_histogram(name: str, value: float) -> None:
    with _LOCK:
        h = _HISTOGRAMS[name]
        h.append(value)
        if len(h) > 4096:
            del h[: len(h) // 2]


def snapshot() -> str:
    """Prometheus text exposition."""
    lines = []
    with _LOCK:
        for name, value in sorted(_COUNTERS.items()):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {value}")
        for name, value in sorted(_GAUGES.items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {value}")
        for name, values in sorted(_HISTOGRAMS.items()):
            lines.append(f"# TYPE {name} summary")
            if values:
                s = sorted(values)
                lines.append(f"{name}{{quantile=\"0.5\"}} {s[len(s) // 2]}")
                lines.append(f"{name}{{quantile=\"0.9\"}} {s[int(len(s) * 0.9)]}")
                lines.append(f"{name}_sum {sum(values)}")
            lines.append(f"{name}_count {len(values)}")
    return "\n".join(lines) + "\n"


async def serve(port: int = 9000) -> asyncio.AbstractServer:
    """Serve /metrics on the given port."""

    async def handle(reader, writer):
        try:
            await reader.readline()
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
            body = snapshot().encode()
            writer.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: text/plain; version=0.0.4\r\n"
                + f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
                + body
            )
            await writer.drain()
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    return await asyncio.start_server(handle, "127.0.0.1", port)


def reset() -> None:
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTOGRAMS.clear()
