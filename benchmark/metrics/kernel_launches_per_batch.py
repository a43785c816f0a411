"""Kernel launches a request in the traced requests: the program's
``launch.<wrapper>`` counters (every ctypes launch, ``ops/_build.count``)
over the profiled requests, from the program's own recording."""

from benchmark import recording


def read(ctx):
    return recording.counted_per_request(ctx, "launch.")
