"""score_train.attention_ms (ms): device time a step in `score_train.attention` (the pair
self-attention, the mean-pool, the cross-hypothesis attention, the logit and the group loss,
models/training.py::score_loss_fn), read from the program's recorder (benchmark/score_train_spans.py).
Moves train_step_ms."""

from benchmark import score_train_spans


def read(ctx):
    return score_train_spans.device_ms(ctx, "score_train.attention")
