"""nerf.mlp_ms (ms): device time a step in the stage `nerf.mlp`: NeRFSmall, the band weights and the five losses (nerf/model.py, nerf/runner.py), read
from the program's recorder (benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "nerf", "nerf.mlp")
