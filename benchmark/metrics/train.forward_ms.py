"""train.forward_ms (ms): device time a step in `train.forward` (models/training.py _step:
RefineNet's forward and the loss), read from the program's recorder
(benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "train.forward")
