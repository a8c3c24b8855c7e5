"""Faults planted under train-scorer's step, for the readings its limits of
`correct` are set from. benchmark/faults.py plants `half_batch` and
`altered` in the refiner's loss, which a scorer step never calls; here
they patch `training.score_loss_fn`, and `unchanged` is faults.py's own
(the optimizer's update skipped, through `training._step`):

- `unchanged`: the step leaves the net as it was;
- `half_batch`: the loss over the first half of the group alone;
- `altered`: the loss scaled by 1.5 before its backward pass.

    python3 benchmark/score_train_faults.py --fault half_batch --seeds 1,2,3 [--seconds 3]

One JSON line a seed, as benchmark/calibrate.py prints them.
"""
import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import calibrate, faults  # noqa: E402


@contextlib.contextmanager
def planted(fault: str):
    if fault == "unchanged":
        with faults.planted("score_train", fault):
            yield
        return
    from foundationpose_torch.models import training

    loss_fn = training.score_loss_fn

    def loss_fault(module, batch, dtype):
        if fault == "half_batch":
            h = batch["A"].shape[0] // 2
            return loss_fn(module, {k: v[:h] for k, v in batch.items()}, dtype)
        return loss_fn(module, batch, dtype) * 1.5

    training.score_loss_fn = loss_fault
    try:
        yield
    finally:
        training.score_loss_fn = loss_fn


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="train-scorer")
    p.add_argument("--fault", required=True, choices=faults.FAULTS)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args()
    for seed in (int(x) for x in a.seeds.split(",") if x):
        with planted(a.fault):
            r = calibrate.reading(a.workload, seed, a.seconds)
        print(json.dumps(r | {"side": a.fault}), flush=True)


if __name__ == "__main__":
    main()
