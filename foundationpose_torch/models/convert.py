"""JAX param trees and .npz checkpoints -> state_dicts of the port's nets.

The inverse of foundationpose_tpu/models/convert.py: a JAX param tree
(nested dicts of numpy arrays, as the JAX package's init_* functions and
`.npz` checkpoints hold them) becomes a state_dict with the reference
torch names. Layout changes:
  conv kernel (kh, kw, I, O)  -> weight (O, I, kh, kw)
  linear kernel (I, O)        -> weight (O, I)
  BN scale/bias/mean/var      -> weight/bias/running_mean/running_var
"""
from __future__ import annotations

import json

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"])))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(p["mean"])
    sd[f"{prefix}.running_var"] = _t(p["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _conv_bn(sd, prefix, p, use_bn):
    _conv(sd, f"{prefix}.net.0", p["conv"])
    if use_bn:
        _bn(sd, f"{prefix}.net.1", p["bn"])


def _res(sd, prefix, p, use_bn):
    _conv(sd, f"{prefix}.conv1", p["conv1"])
    _conv(sd, f"{prefix}.conv2", p["conv2"])
    if use_bn:
        _bn(sd, f"{prefix}.bn1", p["bn1"])
        _bn(sd, f"{prefix}.bn2", p["bn2"])


def _trunks(sd, name_a, name_ab, tree, use_bn):
    a, ab = tree[name_a], tree[name_ab]
    _conv_bn(sd, f"{name_a}.0", a["0"], use_bn)
    _conv_bn(sd, f"{name_a}.1", a["1"], use_bn)
    _res(sd, f"{name_a}.2", a["2"], use_bn)
    _res(sd, f"{name_a}.3", a["3"], use_bn)
    for i in ("0", "1", "3", "4"):
        _res(sd, f"{name_ab}.{i}", ab[i], use_bn)
    _conv_bn(sd, f"{name_ab}.2", ab["2"], use_bn)


def _mha(sd, prefix, p):
    sd[f"{prefix}.in_proj_weight"] = _t(np.transpose(np.asarray(p["in_proj"]["kernel"])))
    sd[f"{prefix}.in_proj_bias"] = _t(p["in_proj"]["bias"])
    _linear(sd, f"{prefix}.out_proj", p["out_proj"])


def _encoder_layer(sd, prefix, p):
    _mha(sd, f"{prefix}.self_attn", p["self_attn"])
    _linear(sd, f"{prefix}.linear1", p["linear1"])
    _linear(sd, f"{prefix}.linear2", p["linear2"])
    for n in ("norm1", "norm2"):
        sd[f"{prefix}.{n}.weight"] = _t(p[n]["scale"])
        sd[f"{prefix}.{n}.bias"] = _t(p[n]["bias"])


def params_from_jax(tree: dict, cfg) -> dict:
    """JAX RefineNet or ScoreNet param tree -> state_dict of the port's
    RefineNet / ScoreNetMultiPair; `cfg` is the net config (use_bn)."""
    sd: dict = {}
    if "encodeA" in tree:
        _trunks(sd, "encodeA", "encodeAB", tree, cfg.use_bn)
        for head in ("trans_head", "rot_head"):
            _encoder_layer(sd, f"{head}.0", tree[head]["0"])
            _linear(sd, f"{head}.1", tree[head]["1"])
    elif "encoderA" in tree:
        _trunks(sd, "encoderA", "encoderAB", tree, cfg.use_bn)
        _mha(sd, "att", tree["att"])
        _mha(sd, "att_cross", tree["att_cross"])
        _linear(sd, "linear", tree["linear"])
    else:
        raise ValueError("not a RefineNet or ScoreNet param tree")
    return sd


_META_KEY = "__meta_json__"


def load_npz_params(path: str):
    """Read a param .npz written by the JAX package's save_params.

    Keys are '/'-joined tree paths. Returns (tree, meta dict or None)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta = None
    if _META_KEY in flat:
        meta = json.loads(flat.pop(_META_KEY).tobytes().decode("utf-8"))
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return tree, meta
