"""nerf.grid_backward_ms (ms): device time a step in the stage `nerf.grid_backward`: the table gradient inside autograd's backward: K4 and its fold (ops/hashgrid.py, csrc/segment_add.cu), read
from the program's recorder (benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "nerf", "nerf.grid_backward")
