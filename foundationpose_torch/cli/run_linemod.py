"""LINEMOD benchmark entry point (reference: run_linemod.py).

Thin alias over the unified BOP driver (cli/run_bop.py) with the dataset
pinned to 'lm'.
"""
import sys

from .run_bop import main as _main


def main(argv=None):
    args = list(argv) if argv is not None else sys.argv[1:]
    if not any(a.startswith("--dataset") for a in args):
        args = ["--dataset", "lm"] + args
    return _main(args)


if __name__ == "__main__":
    main()
