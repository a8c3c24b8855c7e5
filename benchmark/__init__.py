"""The benchmark of foundationpose_torch: `python3 benchmark/run.py --help`."""
