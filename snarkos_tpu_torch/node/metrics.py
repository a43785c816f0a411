"""Metrics registry + Prometheus text exposition (node/metrics semantics).

Mirrors SURVEY.md §6.5: gauges and histograms (BFT round/height, block
composition, mempool depth, commit latency, the Prover's iterations and
solutions) updated from the node's hot paths, and the counters of the port's
one registry (``utils/tracing.py``: kernel launches, engine calls, copies
between host and device, reruns and builds), served as Prometheus text format
on an HTTP port (default 9000).

The port of ``snarkos_tpu/node/metrics.py``.
"""

from __future__ import annotations

import asyncio
import re
import threading
from collections import defaultdict

from snarkos_tpu_torch.utils import tracing

_LOCK = threading.Lock()
_GAUGES: dict[str, float] = {}
_HISTOGRAMS: dict[str, list] = defaultdict(list)


def increment_counter(name: str, value: float = 1.0) -> None:
    tracing.count(name, value)


def update_gauge(name: str, value: float) -> None:
    with _LOCK:
        _GAUGES[name] = value


def observe_histogram(name: str, value: float) -> None:
    with _LOCK:
        h = _HISTOGRAMS[name]
        h.append(value)
        if len(h) > 4096:
            del h[: len(h) // 2]


def _prometheus_name(name: str) -> str:
    """A registry name as a Prometheus metric name: ``launch.add_kernel`` ->
    ``launch_add_kernel``."""
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def snapshot() -> str:
    """Prometheus text exposition."""
    lines = []
    for name, value in tracing.counters().items():
        name = _prometheus_name(name)
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {value}")
    with _LOCK:
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
    tracing.reset()
    with _LOCK:
        _GAUGES.clear()
        _HISTOGRAMS.clear()
