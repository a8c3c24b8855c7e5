"""train.batch_ms (ms): device time between the benchmark's CUDA events around
make_refiner_batch (datasets/synthetic.py: draws, 2 K1 renders, crops, targets), per step of the traced stretch. Moves train_step_ms."""


def read(ctx):
    if ctx.kind != "train" or not ctx.spans:
        return None
    return sum(m[0].elapsed_time(m[0 + 1]) for m in ctx.spans) / len(ctx.spans)
