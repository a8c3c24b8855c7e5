"""register.crops_ms (ms): device time a register in its step's `crops` and `score.crops`
stages (pipeline/crops.py make_crop_inputs: K1 renders, warp_crop, centring), every
refine iteration's and the scorer's, read from the program's recorder
(benchmark/spans.py). Moves register_ms."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "register", "crops", "score.crops")
