"""Coefficients committed in the commitments completed in the window, over
the window's wall time (from its start to the return of its last commit)."""


def read(ctx):
    return ctx.rate() if ctx.window.done else None
