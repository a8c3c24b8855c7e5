"""track.host_ms (ms): the host's time a frame in track_one's spans (window, upload and
pack, step launch, fetch, check, re-run) less its `track.wait` spans, the blocking
fetches, read from the program's recorder (benchmark/spans.py). Moves track_ms."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "track", "track.wait")
