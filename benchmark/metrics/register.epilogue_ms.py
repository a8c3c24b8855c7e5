"""register.epilogue_ms (ms): device time per register in the fused layer
epilogue kernel (ops/epilogue_cuda.py, csrc/epilogue.cu: the bias, BN,
residual and ReLU after each conv and linear of RefineNet and ScoreNet).
Nothing to read where the kernel did not run. Moves register_ms."""

KERNELS = ("fp_epilogue",)


def matches(name):
    return any(k in name for k in KERNELS)


def read(ctx):
    if ctx.kind != "register":
        return None
    spent = ctx.summary.kernel_s(matches)
    if spent == 0:
        return None
    return spent / ctx.traced.served * 1e3
