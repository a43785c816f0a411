"""Nonces proved in the batches completed in the window, over the window's
wall time (from its start to the return of its last batch)."""


def read(ctx):
    return ctx.rate() if ctx.window.done else None
