"""track.pack_ms (ms): the host's time a frame in `track.pack` (the window packed into the
pinned slot) and `track.upload` (the slot's wait and the copy's launch), self times,
read from the program's recorder (benchmark/spans.py). Moves track_ms."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "track", "track.pack", "track.upload")
