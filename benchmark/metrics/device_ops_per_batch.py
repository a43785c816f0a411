"""Device activities (kernels, copies, fills) in the traced window, a
request: what the host's Python issues one by one."""


def read(ctx):
    t = ctx.trace
    return t.device_ops / t.requests if t and t.requests else None
