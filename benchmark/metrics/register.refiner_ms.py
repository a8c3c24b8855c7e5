"""register.refiner_ms (ms): device time a register in its step's `refiner` (RefineNet) and
`update` (apply_pose_delta) stages, every iteration's, read from the program's recorder
(benchmark/spans.py). Moves register_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "register", "refiner", "update")
