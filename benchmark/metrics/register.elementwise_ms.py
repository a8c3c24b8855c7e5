"""register.elementwise_ms (ms): device time per register in PyTorch's
elementwise and reduction kernels, the networks' layer epilogues
(models/layers.py: bias adds, BN, casts, residual adds, norms). Moves
register_ms."""

KERNELS = ("elementwise_kernel", "reduce_kernel", "CatArrayBatchedCopy", "index_elementwise")


def matches(name):
    return any(k in name for k in KERNELS)


def read(ctx):
    if ctx.kind != "register":
        return None
    return ctx.summary.kernel_s(matches) / ctx.traced.served * 1e3
