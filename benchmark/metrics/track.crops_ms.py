"""track.crops_ms (ms): device time a tracked frame in its step's `crops` stages
(make_crop_inputs: K1 render, warp_crop, centring), read from the program's recorder
(benchmark/spans.py). Moves track_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "track", "crops")
