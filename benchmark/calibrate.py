"""Readings that the limits of `correct` are set from, for one cell, in one
process on the card: `harness.run` of the program over many seeds (a short
window each), of the control (the reference computed in fp8 in the
program's place) and, with --fault, of the program with a fault planted
under its timed path (benchmark/faults.py).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault half_batch --fault-seeds 7,8,9] [--seconds 3]

One JSON line a seed; not run by the benchmark's own runs.
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import faults, harness  # noqa: E402


def reading(workload, seed, seconds, control=False, fault=None):
    tr = harness.load_traffic(harness.find_cell(harness.manifest(), workload)["traffic"])
    t0 = time.perf_counter()
    with faults.planted(tr["kind"], fault) if fault else contextlib.nullcontext():
        r = harness.run(workload, seed, seconds, False, control=control, t_start=t0)
    return {"seed": seed, "side": "control" if control else (fault or "program"), "correct": r["correct"],
            "checks": {k: v["value"] for k, v in r["checks"].items()}, "numbers": r["numbers"],
            "served": r["attempted"], "setup_s": r["metrics"]["setup_s"]["value"],
            "reruns": r.get("full_frame_reruns"), "peak_bytes": r["device"]["memory_peak_bytes"]}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None, choices=faults.FAULTS)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args()
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    runs = ([(s, False, None) for s in seeds(a.seeds)] + [(s, True, None) for s in seeds(a.control_seeds)]
            + [(s, False, a.fault) for s in seeds(a.fault_seeds)])
    for seed, control, fault in runs:
        print(json.dumps(reading(a.workload, seed, a.seconds, control, fault)), flush=True)


if __name__ == "__main__":
    main()
