"""track.rerun_share (%): share of the traced frames whose request holds a `track.rerun`
span: a full-frame re-run after the window check or a chain repair, read from the
program's recorder (benchmark/spans.py). Moves track_ms."""

from benchmark import spans


def read(ctx):
    return spans.share_holding(ctx, "track", "track.rerun")
