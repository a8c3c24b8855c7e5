"""score_train.mfu (%): model FLOPs of the scorer steps served in the untraced stretch
(benchmark/flops.py: each pair's trunk and self-attention, the cross-hypothesis attention and logit,
backward at twice the forward) over that stretch's seconds at the bf16 peak of one H100
(benchmark/peaks.py): the whole step's share of the peak. Moves train_step_ms."""

from benchmark.peaks import PEAK_OPS_PER_S


def read(ctx):
    if ctx.kind != "score_train" or ctx.untraced.served == 0:
        return None
    work = ctx.driver.flops_per_request() * ctx.untraced.served
    return work / (ctx.untraced.seconds * PEAK_OPS_PER_S["bf16"]) * 100.0
