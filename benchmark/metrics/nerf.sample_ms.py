"""nerf.sample_ms (ms): device time a step in the stage `nerf.sample`: the batch gather, the frame corrections and both samplers (nerf/runner.py, nerf/occupancy.py), read
from the program's recorder (benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "nerf", "nerf.sample")
