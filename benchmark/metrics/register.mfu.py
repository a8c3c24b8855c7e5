"""register.mfu (%): model FLOPs of the registers served in the untraced stretch
(benchmark/flops.py: convolutions, linear layers, attention products)
over that stretch's seconds at the bf16 peak of one H100
(benchmark/peaks.py). Moves register_ms."""

from benchmark.peaks import PEAK_OPS_PER_S


def read(ctx):
    if ctx.kind != "register" or ctx.untraced.served == 0:
        return None
    work = ctx.driver.flops_per_request() * ctx.untraced.served
    return work / (ctx.untraced.seconds * PEAK_OPS_PER_S["bf16"]) * 100.0
