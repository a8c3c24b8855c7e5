"""Small host-side utilities from the reference's grab-bag (Utils.py).

A copy of foundationpose_tpu/utils/misc.py; `set_seed` also seeds torch."""
from __future__ import annotations

from collections import OrderedDict, defaultdict

import numpy as np


def rle_to_mask(rle: dict) -> np.ndarray:
    """Binary mask from an uncompressed RLE (Utils.py:442-453, SAM-style)."""
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx : idx + count] = parity
        idx += count
        parity ^= True
    return mask.reshape(w, h).transpose()


def set_seed(seed: int) -> None:
    """Determinism guard (Utils.py:222-229): seeds python's, numpy's and
    torch's global generators (torch's on every card too)."""
    import random

    import torch

    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def make_yaml_dumpable(D):
    """Recursively convert numpy containers for yaml dump (Utils.py:996-1020)."""
    if isinstance(D, np.ndarray):
        return D.tolist()
    if isinstance(D, (dict, OrderedDict, defaultdict)):
        return {k: make_yaml_dumpable(v) for k, v in D.items()}
    if isinstance(D, (list, tuple)):
        return [make_yaml_dumpable(x) for x in D]
    if isinstance(D, (np.integer,)):
        return int(D)
    if isinstance(D, (np.floating,)):
        return float(D)
    return D
