"""register.conv_ms (ms): device time per register in cuDNN's convolution
kernels and their layout transforms (models/networks.py). Moves
register_ms."""

KERNELS = ("fprop", "conv", "cudnn", "implicit_gemm", "nchwToNhwc", "nhwcToNchw", "Winograd")


def matches(name):
    return any(k in name for k in KERNELS)


def read(ctx):
    if ctx.kind != "register":
        return None
    return ctx.summary.kernel_s(matches) / ctx.traced.served * 1e3
