"""Run one benchmark cell of foundationpose_torch once on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
`device`, with --trace 1 `breakdown`, and last `checks` (each number
compared with the plain reference, beside its limit; also the last lines
on standard error). Exits nonzero with no result without enough CUDA
cards, or when a forbidden module (JAX, the JAX package) was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
