"""Parameter checkpoints: one flat .npz per param tree, with JSON meta.

Port of the parameter half of foundationpose_tpu/utils/checkpoint.py
(`save_params`, `load_params`, `load_params_meta`); the files are the
same, so either package reads what the other writes. Keys are the
'/'-joined tree paths; list indices flatten as '#i' so they stay apart
from dicts with digit-string keys (the network trees' "0", "1" blocks).
"""
from __future__ import annotations

import json
import os

import numpy as np

_META_KEY = "__meta_json__"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val

    def listify(d):
        if not isinstance(d, dict):
            return d
        keys = list(d)
        if keys and all(k.startswith("#") and k[1:].isdigit() for k in keys):
            return [listify(d[f"#{i}"]) for i in range(len(keys))]
        return {k: listify(v) for k, v in d.items()}

    return listify(root)


def save_params(path: str, params, meta: dict | None = None) -> None:
    """Save a nested dict/list param tree of arrays to one .npz; `meta`
    (JSON-serializable) rides along under a reserved key, so weights
    carry the config they were trained or converted under."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(params)
    if meta is not None:
        flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **flat)


def load_params(path: str):
    return load_params_meta(path)[0]


def load_params_meta(path: str):
    """Returns (params, meta dict or None)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta = None
    if _META_KEY in flat:
        meta = json.loads(flat.pop(_META_KEY).tobytes().decode("utf-8"))
    return _unflatten(flat), meta
