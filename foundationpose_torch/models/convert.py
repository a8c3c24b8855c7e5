"""Checkpoints of the nets: JAX param trees, reference torch state dicts
and .npz files, to and from the port's state_dicts; and the neural
object field's params (`nerf_params_from_jax`).

Port of foundationpose_tpu/models/convert.py, both ways. The port's nets
carry the reference torch names (learning/models/*.py), so a reference
`.pth` state dict loads into them as it is (`load_torch_state_dict`); a
JAX param tree (nested dicts of numpy arrays, as the JAX package's
init_* functions and `.npz` checkpoints hold them) maps onto the same
names (`params_from_jax`) and back (`params_to_jax`). Layouts:
  conv kernel (kh, kw, I, O)  <-> weight (O, I, kh, kw)
  linear kernel (I, O)        <-> weight (O, I)
  BN scale/bias/mean/var      <-> weight/bias/running_mean/running_var
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.checkpoint import load_params_meta


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"])))
    sd[f"{prefix}.bias"] = _t(p["bias"])


_BN = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var"))
# (JAX layout -> torch layout, torch layout -> JAX layout)
_LAYOUTS = {
    "conv": (lambda a: np.transpose(a, (3, 2, 0, 1)), lambda a: np.transpose(a, (2, 3, 1, 0))),
    "linear": (np.transpose, np.transpose),
    "vec": (lambda a: a, lambda a: a),
}


def _param_map(scorer: bool, use_bn: bool):
    """(JAX tree path, state_dict name, layout) of every parameter of a
    RefineNet (scorer False) or ScoreNetMultiPair."""
    out = []

    def dense(jp, tp, layout):
        out.append((jp + ("kernel",), f"{tp}.weight", layout))
        out.append((jp + ("bias",), f"{tp}.bias", "vec"))

    def bn(jp, tp):
        out.extend((jp + (j,), f"{tp}.{t}", "vec") for j, t in _BN)

    def conv_bn(jp, tp):
        dense(jp + ("conv",), f"{tp}.net.0", "conv")
        if use_bn:
            bn(jp + ("bn",), f"{tp}.net.1")

    def res(jp, tp):
        for i in ("1", "2"):
            dense(jp + (f"conv{i}",), f"{tp}.conv{i}", "conv")
        if use_bn:
            for i in ("1", "2"):
                bn(jp + (f"bn{i}",), f"{tp}.bn{i}")

    def mha(jp, tp):
        out.append((jp + ("in_proj", "kernel"), f"{tp}.in_proj_weight", "linear"))
        out.append((jp + ("in_proj", "bias"), f"{tp}.in_proj_bias", "vec"))
        dense(jp + ("out_proj",), f"{tp}.out_proj", "linear")

    a, ab = ("encoderA", "encoderAB") if scorer else ("encodeA", "encodeAB")
    for i, block in enumerate((conv_bn, conv_bn, res, res)):
        block((a, str(i)), f"{a}.{i}")
    for i, block in enumerate((res, res, conv_bn, res, res)):
        block((ab, str(i)), f"{ab}.{i}")
    if scorer:
        mha(("att",), "att")
        mha(("att_cross",), "att_cross")
        dense(("linear",), "linear", "linear")
        return out
    for head in ("trans_head", "rot_head"):
        layer = (head, "0")
        mha(layer + ("self_attn",), f"{head}.0.self_attn")
        for lin in ("linear1", "linear2"):
            dense(layer + (lin,), f"{head}.0.{lin}", "linear")
        for norm in ("norm1", "norm2"):
            out.append((layer + (norm, "scale"), f"{head}.0.{norm}.weight", "vec"))
            out.append((layer + (norm, "bias"), f"{head}.0.{norm}.bias", "vec"))
        dense((head, "1"), f"{head}.1", "linear")
    return out


def params_from_jax(tree: dict, cfg) -> dict:
    """JAX RefineNet or ScoreNet param tree -> state_dict of the port's
    RefineNet / ScoreNetMultiPair; `cfg` is the net config (use_bn)."""
    if "encodeA" not in tree and "encoderA" not in tree:
        raise ValueError("not a RefineNet or ScoreNet param tree")
    sd: dict = {}
    for path, name, layout in _param_map("encoderA" in tree, cfg.use_bn):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        sd[name] = _t(_LAYOUTS[layout][0](np.asarray(leaf)))
        if name.endswith(".running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def opt_state_from_jax(opt_state, module, optimizer) -> dict:
    """An optax Adam or AdamW state of a RefineNet / ScoreNet param tree
    -> a state dict for `optimizer.load_state_dict`, so that a run begun
    in the JAX package goes on in the port.

    `opt_state`: the optax state (the element of its chain that carries
    `count`, `mu` and `nu`) or a dict with those keys, leaves as numpy
    arrays; `module` the port's net, `optimizer` its
    models.training.make_optimizer (torch.optim.Adam / AdamW over
    `trainable_tensors(module)`)."""
    if isinstance(opt_state, dict):
        adam = opt_state
    else:
        adam = next(s for s in opt_state if hasattr(s, "mu"))._asdict()
    count = float(np.asarray(adam["count"]))
    mu = params_from_jax(adam["mu"], module.cfg)
    nu = params_from_jax(adam["nu"], module.cfg)
    names = {id(t): n for n, t in module.state_dict(keep_vars=True).items()}
    sd = optimizer.state_dict()
    tensors = [t for group in optimizer.param_groups for t in group["params"]]
    sd["state"] = {
        i: {"step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[names[id(t)]].to(t.device),
            "exp_avg_sq": nu[names[id(t)]].to(t.device)}
        for i, t in enumerate(tensors)
    }
    return sd


def params_to_jax(sd: dict) -> dict:
    """The inverse of params_from_jax: a RefineNet / ScoreNetMultiPair
    state_dict -> the JAX package's param tree (numpy f32), as its
    FoundationPose.save_weights writes it."""
    tree: dict = {}
    for path, name, layout in _param_map("encoderA.0.net.0.weight" in sd, detect_use_bn(sd)):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        a = sd[name].detach().to("cpu", torch.float32).numpy()
        node[path[-1]] = np.array(_LAYOUTS[layout][1](a), order="C")  # a copy: never a view of sd
    return tree


def detect_use_bn(sd: dict) -> bool:
    return any("running_mean" in k for k in sd)


def _convert(sd: dict, use_bn: bool, scorer: bool) -> dict:
    if ("encoderA.0.net.0.weight" in sd) != scorer:
        raise ValueError(f"the state dict holds a {'refiner' if scorer else 'scorer'}")
    if detect_use_bn(sd) != use_bn:
        raise ValueError(f"use_bn={use_bn}, but the state dict {'lacks' if use_bn else 'has'} BatchNorm statistics")
    return params_to_jax(sd)


def convert_refine_net(sd: dict, use_bn: bool) -> dict:
    """A reference RefineNet state dict -> the JAX package's param tree
    (its models.convert.convert_refine_net)."""
    return _convert(sd, use_bn, scorer=False)


def convert_score_net(sd: dict, use_bn: bool) -> dict:
    """A reference ScoreNetMultiPair state dict -> the JAX param tree."""
    return _convert(sd, use_bn, scorer=True)


def load_torch_state_dict(path: str) -> dict:
    """A reference `.pth` checkpoint -> {name: CPU tensor}.

    Tolerates the wrappers seen in the wild: a {'model': ...} or
    {'state_dict': ...} envelope (predict_pose_refine.py:139-140) and
    DataParallel / DistributedDataParallel 'module.' key prefixes.
    Non-tensor entries are dropped, and so is the reference's
    positional-embedding table (`pos_embed.pe`, a constant sinusoid the
    port computes for its token count). The file is unpickled in full:
    load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for wrapper in ("model", "state_dict"):
        if wrapper in ckpt and isinstance(ckpt[wrapper], dict):
            ckpt = ckpt[wrapper]
            break
    out = {}
    for k, v in ckpt.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor) and k != "pos_embed.pe":
            out[k] = v.detach().cpu()
    return out


def load_npz_params(path: str):
    """Read a param .npz written by either package's save_params.
    Returns (tree, meta dict or None)."""
    return load_params_meta(path)


def _nerf_sd(tree) -> dict:
    sd = {"grid": _t(tree["grid"])}
    for head in ("sigma", "color"):
        for i, p in enumerate(tree["mlp"][head]):
            _linear(sd, f"mlp.{head}.{i}", p)
    sd["features"] = _t(tree["features"])
    sd["pose"] = _t(tree["pose"])
    return sd


def nerf_params_from_jax(params: dict, opt_state=None):
    """A JAX NerfRunner's params tree (grid, mlp, features, pose) -> a
    state_dict of the port's nerf.runner.NerfModel, MLP kernels
    transposed into nn.Linear layout.

    With `opt_state` (the optax chain's state: clip, Adam, schedule; leaves
    as numpy arrays), also returns the Adam moments as state_dicts and
    the update count: (state_dict, {"count", "mu", "nu"}); else
    (state_dict, None)."""
    sd = _nerf_sd(params)
    if opt_state is None:
        return sd, None
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    opt = {"count": int(np.asarray(adam.count)), "mu": _nerf_sd(adam.mu), "nu": _nerf_sd(adam.nu)}
    return sd, opt
