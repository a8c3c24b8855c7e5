"""nerf.encode_ms (ms): device time a step in the stage `nerf.encode`: the hash-grid forward (ops/hashgrid.py), read
from the program's recorder (benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "nerf", "nerf.encode")
