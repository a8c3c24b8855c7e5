"""Parameter checkpoints (one flat .npz per param tree, with JSON meta)
and train-state checkpoints (torch.save).

Port of foundationpose_tpu/utils/checkpoint.py. The parameter half
(`save_params`, `load_params`, `load_params_meta`) writes the same
files, so either package reads what the other writes; keys are the
'/'-joined tree paths, and list indices flatten as '#i' so they stay
apart from dicts with digit-string keys (the network trees' "0", "1"
blocks). The train-state half (`save_train_state`, `latest_step`,
`load_train_state`) keeps the JAX package's `step_{step:07d}`
directories and `step=None` loading the latest, with torch.save of the
state (for example the module's and the optimizer's state_dicts) in
place of orbax.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

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


_STATE_FILE = "state.pt"


def save_train_state(ckpt_dir: str, step: int, state) -> None:
    """torch.save `state` (tensors, numbers, strings and their dicts,
    lists and tuples: state_dicts) as ckpt_dir/step_{step:07d}/state.pt;
    written to a temporary name first, so a reader never sees half a
    file."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:07d}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def load_train_state(ckpt_dir: str, step: int | None = None, map_location=None):
    """-> (step, state); step=None loads the latest. Loads with
    weights_only=True: plain containers of tensors and numbers only."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:07d}", _STATE_FILE)
    return step, torch.load(path, map_location=map_location, weights_only=True)
