"""score_train.batch_ms (ms): device time between the benchmark's CUDA events around
make_scorer_batch (datasets/synthetic.py: the frame's K1 render, the group's crops by K1 and warps,
the targets), per step of the traced stretch. Moves train_step_ms."""


def read(ctx):
    if ctx.kind != "score_train" or not ctx.spans:
        return None
    return sum(m[0].elapsed_time(m[1]) for m in ctx.spans) / len(ctx.spans)
