"""setup_s (s): process start to the window's start, on the host clock:
imports, inputs and weights made from the seed, kernels built, every shape
the cell's traffic reaches run and captured."""


def read(ctx):
    return ctx.setup_s
