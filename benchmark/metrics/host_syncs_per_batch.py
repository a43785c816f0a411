"""The CUDA runtime's synchronising calls (stream, device and event
synchronize) in the traced window, a request: each a stall of the host
until the device drains."""


def read(ctx):
    t = ctx.trace
    return t.host_syncs / t.requests if t and t.requests else None
