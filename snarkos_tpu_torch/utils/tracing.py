"""The port's counters and spans.

Counters are always on: ``count(name, n)`` adds to the process's one
registry under one lock, and ``counters(prefix)`` reads it. The names:

  launch.<wrapper>      every ctypes kernel launch (``ops/_build.count``)
  engine.<entry>        every call of a host engine entry (``utils/native``)
  copy.<site>           every blocking copy between the host and a device
                        that the port issues (``to_host``, ``copied``); a
                        copy on the host alone (a CPU run) is not one
  msm.rerun             ``msm_affine``'s complete engine run again after the
                        fast one's exception flag
  epoch_program.build   ``Puzzle.epoch_program`` building a program
  kernel.build          each library ``ops/_build.build`` compiles

and whatever the node counts through ``node/metrics.increment_counter``.

``declare`` puts a name in the registry at 0 before its first event, so that
the node's ``/metrics`` serves it from the start.

Spans are recorded only while a ``torch.profiler`` session records: with no
session, ``span(phase, site)`` returns one shared null context after a
single read of the profiler's flag. In a session it opens
``record_function("layer:<phase>:<site>")``, so that the span lies in the
device trace, and keeps a ``SpanRecord`` of it (host clock
``time.perf_counter_ns``, parent span, the root span's id as the request
id, thread) in the session's ``Recording``.

A recording starts at the first count or span that finds a session on; a
count that finds the session off ends it. While it lasts every count is
also added to its ``tally``, so the tally is what the profiled requests
counted. ``recording()`` returns the newest.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

LOCK = threading.Lock()
MAX_SPANS = 1 << 16  # the span records a recording keeps; later ones are dropped
SPAN_PREFIX = "layer:"
HOST = "cpu"  # the device type whose tensors need no copy to reach the host

_COUNTS: dict[str, int] = {}
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_current = None  # the recording of the session that records now
_last = None  # the newest recording


class SpanRecord(NamedTuple):
    id: int
    phase: str
    site: str
    start_ns: int
    end_ns: int
    parent: int | None
    request: int  # the id of the span's root span
    thread: int


class Recording:
    """What one profiler session saw the program count and span."""

    def __init__(self):
        self.tally: dict[str, int] = {}
        self.spans: list[SpanRecord] = []
        self.dropped = 0

    def total(self, prefix: str) -> int:
        """The sum of the tally's counters whose name starts with ``prefix``."""
        with LOCK:
            return sum(n for name, n in self.tally.items() if name.startswith(prefix))


def _live() -> Recording | None:
    """The recording of the session that records now (begun here if new),
    or None; call under ``LOCK``."""
    global _current, _last
    if _profiler._is_profiler_enabled:
        if _current is None:
            _current = _last = Recording()
        return _current
    _current = None
    return None


def count(name: str, n: int = 1) -> None:
    with LOCK:
        count_locked(name, n)


def count_locked(name: str, n: int = 1) -> None:
    """``count`` by a caller that holds ``LOCK``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n
    if _profiler._is_profiler_enabled or _current is not None:
        rec = _live()
        if rec is not None:
            rec.tally[name] = rec.tally.get(name, 0) + n


def declare(*names: str) -> None:
    with LOCK:
        for name in names:
            _COUNTS.setdefault(name, 0)


def counters(prefix: str = "") -> dict:
    """The registry's counters whose name starts with ``prefix``, by name."""
    with LOCK:
        return {k: v for k, v in sorted(_COUNTS.items()) if k.startswith(prefix)}


def reset(prefix: str = "") -> None:
    """Take the counters whose name starts with ``prefix`` out of the
    registry."""
    with LOCK:
        for name in [k for k in _COUNTS if k.startswith(prefix)]:
            del _COUNTS[name]


def recording() -> Recording | None:
    return _last


def copied(site: str, device) -> None:
    """Count ``copy.<site>``: a blocking copy between the host and
    ``device`` (None: the host)."""
    if device is None:
        return
    kind = device.type if isinstance(device, torch.device) else torch.device(device).type
    if kind != HOST:
        count("copy." + site)


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t.cpu()``, counted as ``copy.<site>`` where ``t`` lies on a
    device."""
    copied(site, t.device)
    return t.cpu()


class _Span:
    __slots__ = ("phase", "site", "_fn", "_rec", "_id", "_parent", "_request", "_start")

    def __init__(self, phase: str, site: str):
        self.phase, self.site = phase, site

    def __enter__(self):
        with LOCK:
            self._rec = _live()
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        self._id = next(_ids)
        self._parent = parent._id if parent else None
        self._request = parent._request if parent else self._id
        stack.append(self)
        self._fn = _profiler.record_function(f"{SPAN_PREFIX}{self.phase}:{self.site}")
        self._fn.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._fn.__exit__(*exc)
        _local.stack.pop()
        rec = self._rec
        if rec is not None:
            if len(rec.spans) < MAX_SPANS:
                rec.spans.append(SpanRecord(self._id, self.phase, self.site, self._start, end,
                                            self._parent, self._request,
                                            threading.get_ident()))
            else:
                rec.dropped += 1
        return False


def span(phase: str, site: str):
    """A span of the program's phase ``phase`` at ``site`` (a function's
    name): recorded while a profiler session records, else the shared null
    context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(phase, site)
