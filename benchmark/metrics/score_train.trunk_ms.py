"""score_train.trunk_ms (ms): device time a step in `score_train.trunk` (the pair trunk over the
group's 2 x 64 crops, models/training.py::score_loss_fn), read from the program's recorder
(benchmark/score_train_spans.py). Moves train_step_ms."""

from benchmark import score_train_spans


def read(ctx):
    return score_train_spans.device_ms(ctx, "score_train.trunk")
