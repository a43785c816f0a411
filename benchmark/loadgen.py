"""The one traffic generator: a closed loop with one caller. It drives a
cell's ``call(i)`` for a measured window, sending request i + 1 when request
i has returned.

Request i is the cell's i-th request: what it holds (nonces, a polynomial)
is the cell's business, drawn from the traffic mix's parameters
(``benchmark/traffic/<name>.json``) and the seed. A request's latency runs
from when it was sent to when ``call`` returned. The caller stops sending at
the end of the window; the window closes when the last request sent
returns, so a rate is taken over all the work and all the time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Record:
    index: int
    start: float
    end: float
    output: object = None
    error: str | None = None

    @property
    def latency(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    start: float
    end: float
    records: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def done(self) -> list:
        return [r for r in self.records if r.error is None]

    @property
    def failed(self) -> list:
        return [r for r in self.records if r.error is not None]


def run(call, seconds: float, clock=time.perf_counter) -> Window:
    """Drive ``call(i)`` for ``seconds``. A request that raises is recorded
    as failed and stops the run: on a device the next one would fail
    alike."""
    records = []
    start = clock()
    deadline = start + seconds
    i = 0
    while clock() < deadline:
        t0 = clock()
        try:
            out, err = call(i), None
        except Exception as exc:  # recorded, and the run stops
            out, err = None, f"{type(exc).__name__}: {exc}"
        records.append(Record(i, t0, clock(), out, err))
        if err is not None:
            break
        i += 1
    end = records[-1].end if records else clock()
    return Window(start, end, records)


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value that at least
    q percent of the values do not exceed."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, -(-len(ordered) * q // 100))
    return ordered[int(rank) - 1]
