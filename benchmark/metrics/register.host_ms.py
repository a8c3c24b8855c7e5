"""register.host_ms (ms): the host's time a register in FoundationPose.register's spans
(window, upload and pack, step launch, window check, fetch, re-run) less its
`register.wait` spans, the blocking fetches, read from the program's recorder
(benchmark/spans.py). Moves register_ms."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "register", "register.wait")
