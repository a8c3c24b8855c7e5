"""register.scorer_ms (ms): device time a register in its step's `score.net` (ScoreNet or
the depth score) and `rank` (argsorts, the funnel's order) stages, read from the
program's recorder (benchmark/spans.py). Moves register_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "register", "score.net", "rank")
