"""train.backward_ms (ms): device time a step in `train.backward` (loss.backward), read
from the program's recorder (benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "train.backward")
