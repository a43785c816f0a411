"""Blocking copies between the host and the card a request in the traced
requests: the program's ``copy.<site>`` counters (each ``.cpu()`` read and
each upload of host data that the port issues) over the profiled requests,
from the program's own recording."""

from benchmark import recording


def read(ctx):
    return recording.counted_per_request(ctx, "copy.")
