"""train.adam_ms (ms): device time a step in `train.adam` (the optimizer's step), read from
the program's recorder (benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "train.adam")
