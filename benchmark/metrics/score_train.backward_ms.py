"""score_train.backward_ms (ms): device time a scorer step in `train.backward` (loss.backward),
read from the program's recorder (benchmark/score_train_spans.py). Moves train_step_ms."""

from benchmark import score_train_spans


def read(ctx):
    return score_train_spans.device_ms(ctx, "train.backward")
