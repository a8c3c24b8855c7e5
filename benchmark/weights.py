"""Seeded network weights, made on the device in one draw a net.

The distributions are the reference's initialisers: fan-in uniform for
convolution and linear weights (bound sqrt(3 / fan_in)) and biases
(1 / sqrt(fan_in)), xavier-uniform attention in-projections with zero
bias, identity norms and BN statistics. The refiner's two output layers
are scaled by `head_scale`, so that its deltas move a pose by about a
millimetre and a few tenths of a degree an iteration: a random net's raw
deltas throw the object out of view. The scorer is shaped so that its
logits spread well beyond bf16's rounding (`scorer_state`,
`spread_scorer`). The same state dict goes to the program
(`load_state_dict`) and to the reference.
"""
from __future__ import annotations

import math

import torch

from .reference import nets


def _bound(name, shape):
    if name.endswith("in_proj_weight"):
        return math.sqrt(6.0 / (shape[1] + shape[0]))
    if name.endswith(".weight") and len(shape) >= 2:
        return math.sqrt(3.0 / math.prod(shape[1:]))
    return None


def make_state(spec, gen: torch.Generator, device, head_scale: float = 1.0, heads=()):
    """spec: [(name, shape)] (reference/nets.py) -> state dict on `device`."""
    fan_in = {n[: -len(".weight")]: math.prod(s[1:]) for n, s in spec
              if n.endswith(".weight") and len(s) >= 2}
    sizes = [math.prod(s) for _, s in spec]
    draw = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for (name, shape), size in zip(spec, sizes):
        x = draw[at:at + size].reshape(shape)
        at += size
        base = name.rsplit(".", 1)[0]
        if name.endswith("num_batches_tracked"):
            x = torch.zeros((), dtype=torch.int64, device=device)
        elif name.endswith("in_proj_bias") or name.endswith("running_mean") or (
                name.endswith(".bias") and base not in fan_in):
            x = torch.zeros(shape, device=device)  # norm biases, BN means, in-projection bias
        elif name.endswith("running_var") or (name.endswith(".weight") and len(shape) == 1):
            x = torch.ones(shape, device=device)
        elif name.endswith(".bias"):
            x = x / math.sqrt(fan_in[base])
        else:
            x = x * _bound(name, shape)
        if base in heads:
            x = x * head_scale
        out[name] = x.contiguous()
    return out


def refiner_state(cfg: dict, gen, device):
    spec = nets.refine_spec(6, cfg["base_width"], cfg["num_heads"])
    return make_state(spec, gen, device, cfg["head_scale"], ("trans_head.1", "rot_head.1"))


def scorer_state(cfg: dict, gen, device):
    """The scorer's draw, with the BN scale of the trunk's stride-2 layer
    into its last stage times `score_trunk_gain`: a random trunk's
    features are otherwise swamped by the sinusoidal positions, and the
    pooled features of a frame's hypotheses differ by under a percent,
    below bf16's resolution."""
    sd = make_state(nets.score_spec(6, cfg["base_width"], cfg["num_heads"]), gen, device)
    key = "encoderAB.2.net.1.weight"
    sd[key] = sd[key] * cfg["score_trunk_gain"]
    return sd


def spread_scorer(sd: dict, mu: torch.Tensor, scale: float) -> dict:
    """The cross-hypothesis attention made to compare hypotheses by their
    own features: queries and keys scale x (feature - mu), values centered
    on mu, where mu is the pooled features' mean over a sample of a frame's
    hypotheses. A random attention averages features that share one large
    common part, and every hypothesis gets the same logit to rounding."""
    sd = dict(sd)
    d = mu.shape[0]
    w = sd["att_cross.in_proj_weight"].clone()
    b = sd["att_cross.in_proj_bias"].clone()
    eye = torch.eye(d, device=w.device) * scale
    w[:d], w[d:2 * d] = eye, eye
    b[:d], b[d:2 * d] = -scale * mu, -scale * mu
    b[2 * d:] = b[2 * d:] - w[2 * d:] @ mu
    sd["att_cross.in_proj_weight"], sd["att_cross.in_proj_bias"] = w, b
    return sd
