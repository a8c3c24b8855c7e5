"""nerf.adam_ms (ms): device time a step in the stage `nerf.adam`: the global-norm clip and Adam over every leaf (nerf/runner.py apply_gradients), read
from the program's recorder (benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "nerf", "nerf.adam")
