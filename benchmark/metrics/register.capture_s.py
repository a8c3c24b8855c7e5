"""register.capture_s (s): seconds the estimator spent capturing its register steps
(StepGraphs.capture_s; all in set-up), read from the program (benchmark/spans.py). Moves
setup_s."""

from benchmark import spans


def read(ctx):
    return spans.capture_s(ctx, "register")
