"""The device's busy time a request in the traced requests: the union of its
activities over the traced window, over the requests, in milliseconds. The
profiler slows the host, not the device, so this reads as it would
untraced, where the idle share does not."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.requests or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / t.requests
