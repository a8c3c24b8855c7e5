"""Train steps of the refiner and the scorer, their losses and optimizer.

Port of foundationpose_tpu/models/training.py. A step takes the
`nn.Module`, its optimizer, the `TrainCfg` and a batch, updates the
module in place and returns the loss as a 0-d tensor on the module's
device (nothing is read back to the host). The gradients of the step
stay in each tensor's `.grad` until the next step.

Two properties of the JAX package are kept:
- Its BatchNorm is inference-mode, with `mean` and `var` as ordinary
  leaves of the param tree, so `jax.value_and_grad` differentiates them
  and Adam moves them. The port keeps them as the buffers
  `running_mean` / `running_var` (the state_dict names of the
  reference); `make_optimizer` makes them leaves that require a
  gradient and hands them to the optimizer with the parameters
  (`num_batches_tracked` stays out).
- The optimizer is `optax.adam` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
  bias-corrected), or `optax.adamw` when weight_decay > 0 (decoupled
  decay on every leaf: optax's default mask is None).
  `torch.optim.Adam` / `torch.optim.AdamW` compute the same update; they
  round it in another order (the bias corrections in f64 on the host,
  sqrt(nu) / sqrt(1 - b2^t) in place of sqrt(nu / (1 - b2^t))).

While `utils/profiling.py` records, an unsharded step is a request of
kind "train" with the device stages `train.forward` (the loss),
`train.backward` and `train.adam` (the optimizer step), timed by events.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from .. import torch_config  # noqa: F401
from ..parallel.sharding import replicate_tree
from ..torch_config import default_device
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    lr: float = 1e-4
    weight_decay: float = 0.0
    loss_type: str = "l2"  # l1 | l2 (refiner)
    compute_dtype: str = "bfloat16"


def _dtype(cfg: TrainCfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def trainable_tensors(module: nn.Module) -> list[torch.Tensor]:
    """The tensors the JAX param tree holds: every parameter, then the
    running mean and variance of every BatchNorm, made leaves that
    require a gradient (in place of the module's buffers)."""
    out = list(module.parameters())
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            for name in ("running_mean", "running_var"):
                t = getattr(m, name).detach().requires_grad_(True)
                setattr(m, name, t)
                out.append(t)
    return out


def make_optimizer(cfg: TrainCfg, module: nn.Module, device="cuda") -> torch.optim.Optimizer:
    """Move `module` to `device` (without a card "cuda" raises; ask for
    "cpu" for the plain path) and return its Adam, or AdamW when
    cfg.weight_decay > 0, over `trainable_tensors(module)`."""
    module.to(default_device(device))
    tensors = trainable_tensors(module)
    if cfg.weight_decay > 0:
        return torch.optim.AdamW(tensors, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.Adam(tensors, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def refine_loss_fn(module: nn.Module, batch: dict, loss_type: str, dtype) -> torch.Tensor:
    """batch: {'A', 'B': (N, res, res, c), 'trans_target': (N, 3),
    'rot_target': (N, rot_dim)}, targets in the network's output space."""
    out = module(batch["A"], batch["B"], dtype=dtype)
    dt = out["trans"] - batch["trans_target"]
    dr = out["rot"] - batch["rot_target"]
    if loss_type == "l1":
        return dt.abs().mean() + dr.abs().mean()
    return dt.square().mean() + dr.square().mean()


def score_loss_fn(module: nn.Module, batch: dict, dtype) -> torch.Tensor:
    """Softmax cross-entropy of one hypothesis group's logits against the
    softmax of the ADD-derived soft targets batch['target'] (L,), as
    optax.softmax_cross_entropy(logits[None], softmax(target)[None])."""
    logits = module(batch["A"], batch["B"], dtype=dtype)
    labels = torch.softmax(batch["target"], dim=-1)
    return -(labels * torch.log_softmax(logits, dim=-1)).sum()


def _step(optimizer, loss_of):
    optimizer.zero_grad(set_to_none=True)
    with profiling.request("train"), profiling.stages(optimizer.param_groups[0]["params"][0].device):
        profiling.mark("train.forward")
        loss = loss_of()
        profiling.mark("train.backward")
        loss.backward()
        profiling.mark("train.adam")
        optimizer.step()
    return loss.detach()


def _trained(module: nn.Module) -> list[torch.Tensor]:
    """The tensors trainable_tensors hands to the optimizer, in its order,
    as they are (not made leaves again)."""
    out = list(module.parameters())
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            out += [m.running_mean, m.running_var]
    return out


def _dp_step(module: nn.Module, optimizer, mesh, batch: dict, loss_of):
    """One data-parallel step: the batch split along its first axis over
    the mesh, forward and backward of each shard on its replica
    (`loss_of(replicas, shards)` -> the full batch's loss), the gradients
    summed onto the module's tensors (the psum), one optimizer step on
    the module. A replica is `replicate_tree`'s: the module itself on its
    own device, where autograd sums the shards' gradients into it, and
    on another device a copy holding the module's current values, whose
    gradients are added to the module's after the backward."""
    optimizer.zero_grad(set_to_none=True)
    reps = replicate_tree(module, mesh)
    shards = [{} for _ in reps]
    for k, v in batch.items():
        for sh, part, d in zip(shards, torch.tensor_split(v, mesh.size), mesh.devices):
            sh[k] = part.to(d)
    loss = loss_of(reps, shards)
    loss.backward()
    for r in dict.fromkeys(reps):
        if r is module:
            continue
        for p, a in zip(_trained(module), _trained(r)):
            if a.grad is not None:
                g = a.grad.to(p.device)
                p.grad = g if p.grad is None else p.grad + g
    optimizer.step()
    return loss.detach()


def refine_train_step(module: nn.Module, optimizer, train_cfg: TrainCfg, batch: dict, mesh=None):
    """One optimizer step on a refiner batch; returns the loss before it.
    With a `parallel.DeviceMesh`, data-parallel over it: each shard's
    mean loss is weighted by its share of the batch, so the gradient is
    the full batch's."""
    dtype = _dtype(train_cfg)
    if mesh is None:
        return _step(optimizer, lambda: refine_loss_fn(module, batch, train_cfg.loss_type, dtype))
    n = batch["A"].shape[0]
    first = mesh.first

    def loss_of(reps, shards):
        return sum(refine_loss_fn(r, sh, train_cfg.loss_type, dtype).to(first) * (sh["A"].shape[0] / n)
                   for r, sh in zip(reps, shards) if sh["A"].shape[0])

    return _dp_step(module, optimizer, mesh, batch, loss_of)


def score_train_step(module: nn.Module, optimizer, train_cfg: TrainCfg, batch: dict, mesh=None):
    """One optimizer step on a scorer hypothesis group ('A', 'B',
    'target'). With a mesh, data-parallel over it: the group is split,
    each shard's trunk runs on its replica (ScoreNetMultiPair.pooled), and
    the pooled features are gathered onto the first device with their
    gradient for the cross-hypothesis attention over the whole group."""
    dtype = _dtype(train_cfg)
    if mesh is None:
        return _step(optimizer, lambda: score_loss_fn(module, batch, dtype))
    first = mesh.first

    def loss_of(reps, shards):
        feats = torch.cat([r.pooled(sh["A"], sh["B"], dtype).to(first)
                           for r, sh in zip(reps, shards) if sh["A"].shape[0]])
        logits = reps[0].group_logits(feats, dtype)
        labels = torch.softmax(batch["target"].to(first), dim=-1)
        return -(labels * torch.log_softmax(logits, dim=-1)).sum()

    return _dp_step(module, optimizer, mesh, batch, loss_of)
