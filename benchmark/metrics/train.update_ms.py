"""train.update_ms (ms): device time between the benchmark's CUDA events around
refine_train_step (models/training.py: forward, loss, backward, Adam), per step of the traced stretch. Moves train_step_ms."""


def read(ctx):
    if ctx.kind != "train" or not ctx.spans:
        return None
    return sum(m[1].elapsed_time(m[1 + 1]) for m in ctx.spans) / len(ctx.spans)
