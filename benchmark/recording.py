"""What the program itself recorded over a traced run's profiled requests:
the tally of its counters and its span records, kept by
``snarkos_tpu_torch/utils/tracing.py`` for the profiler session that the
traced run opens (``trace.Tracer``). The per-layer metrics of source
``program_counter`` and ``program_span`` read it here. A program without
that module, or one that recorded nothing, gives None, and so do the
metrics that read it."""

from __future__ import annotations


def recording(ctx):
    """The program's recording of the traced requests, or None (an untraced
    run, no module, nothing recorded)."""
    if ctx.trace is None or not ctx.trace.requests:
        return None
    try:
        from snarkos_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.recording()


def counted_per_request(ctx, prefix: str):
    """The recording's counts of the counters named ``<prefix>*``, over the
    traced requests."""
    rec = recording(ctx)
    return None if rec is None else rec.total(prefix) / ctx.trace.requests


def span_ms_per_request(ctx, phase_prefix: str):
    """The host time of the recording's spans whose phase starts with
    ``phase_prefix`` and that no such span holds, in milliseconds, over the
    traced requests."""
    rec = recording(ctx)
    if rec is None:
        return None
    phases = {s.id: s.phase for s in rec.spans}
    ns = sum(s.end_ns - s.start_ns for s in rec.spans
             if s.phase.startswith(phase_prefix)
             and not phases.get(s.parent, "").startswith(phase_prefix))
    return ns * 1e-6 / ctx.trace.requests
