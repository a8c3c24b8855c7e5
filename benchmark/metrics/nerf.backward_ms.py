"""nerf.backward_ms (ms): device time a step in the stage `nerf.backward`: autograd's backward down to the grid, less the table gradient, read
from the program's recorder (benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "nerf", "nerf.backward")
