"""The 95th percentile (nearest rank) of the latency of every commitment in
the window, from when it was sent to when its point was decoded on the host."""

from benchmark import loadgen


def read(ctx):
    lat = [r.latency for r in ctx.window.done]
    return loadgen.percentile(lat, 95) * 1e3 if lat else None
