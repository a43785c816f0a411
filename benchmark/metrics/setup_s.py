"""Set-up: from the start of the process to the start of the window (the
imports, the build of the program's kernels where the checkout has none,
the SRS and the inputs, the warm-up of the cell's shapes)."""


def read(ctx):
    return ctx.setup_s
