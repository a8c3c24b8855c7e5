"""register.prep_ms (ms): device time a register in its step's `prep` stage
(pipeline/graph.py: unpack, depth filters, xyz map, translation guess), read from the
program's recorder (benchmark/spans.py). Moves register_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "register", "prep")
