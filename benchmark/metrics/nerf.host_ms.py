"""nerf.host_ms (ms): the self time a step of the host span `nerf.step`, the host's
dispatch of a neural-object-field step (NerfRunner.train_step), read from the
program's recorder (benchmark/spans.py). Moves train_step_ms."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "nerf", "nerf.step")
