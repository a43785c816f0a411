"""The device's idle share of the traced requests: 1 - the union of its
activities (kernels, copies, fills) over the traced window, in percent. The
profiler's own cost on the host lengthens the traced requests, so this
reads higher than the untraced idle share would."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
