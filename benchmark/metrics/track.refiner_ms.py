"""track.refiner_ms (ms): device time a tracked frame in its step's `refiner` (RefineNet)
and `update` (apply_pose_delta) stages, read from the program's recorder
(benchmark/spans.py). Moves track_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "track", "refiner", "update")
