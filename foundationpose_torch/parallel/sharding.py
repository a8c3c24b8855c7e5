"""Sharding over several devices for the trainers.

Port of foundationpose_tpu/parallel/sharding.py. As there, one host
process drives the devices of a 1-D mesh (no torch.distributed). The
port uses it for data parallelism in training: the batch is split along
its first axis, each device runs forward and backward on a replica of
the net, and the gradients are summed onto the primary net
(`models.training.refine_train_step(..., mesh=...)`). The register runs
on one device: the JAX package's hypothesis sharding has no counterpart
in the estimator, and `shard_hypotheses`, `pad_to_multiple`,
`batch_sharding` and `replicated` have no caller in the package.

A `DeviceMesh` is an ordered list of `torch.device`s and an axis name.
The list may repeat a device: the CPU stands in for n devices that way
(as the JAX tests run on 8 virtual host devices), and so does one card.
PyTorch runs eagerly, so a shard placed on another card runs there while
the host enqueues the next one.
"""
from __future__ import annotations

import copy
import dataclasses
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn as nn

from ..torch_config import default_device, indexed_device

HYP_AXIS = "hyp"
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    devices: tuple[torch.device, ...]
    axis: str = HYP_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def make_device_mesh(n_devices: int | None = None, axis: str = HYP_AXIS,
                     device: str | torch.device = "cuda",
                     devices: Sequence[str | torch.device] | None = None) -> DeviceMesh:
    """A 1-D mesh. `devices`, if given, is the mesh (a device may repeat).
    Else on CUDA the first n cards, cuda:0 to cuda:n-1 (default: all),
    raising when fewer exist; on the CPU n copies of the CPU (default 1)."""
    if devices is not None:
        devs = tuple(indexed_device(d) for d in devices)
        if not devs or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f"n_devices={n_devices} does not match {len(devs)} devices")
        return DeviceMesh(devs, axis)
    dev = default_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if n > have:
            raise RuntimeError(f"a mesh of {n} cards asked for, {have} present")
        return DeviceMesh(tuple(torch.device("cuda", i) for i in range(n)), axis)
    return DeviceMesh((dev,) * (1 if n_devices is None else int(n_devices)), axis)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor is laid on a mesh: split along dim 0 over the mesh
    (`replicate=False`), or one copy on each device. Calling it on a
    tensor returns the per-device pieces, in mesh order."""
    mesh: DeviceMesh
    replicate: bool = False

    def __call__(self, x: torch.Tensor) -> list[torch.Tensor]:
        if self.replicate:
            return [x.to(d) for d in self.mesh.devices]
        if x.shape[0] % self.mesh.size:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over {self.mesh.size} devices")
        return [p.to(d) for p, d in zip(torch.chunk(x, self.mesh.size), self.mesh.devices)]


def batch_sharding(mesh: DeviceMesh, axis: str | None = None) -> Sharding:
    """Split the leading (batch / hypothesis) dim over the mesh."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    return Sharding(mesh)


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, replicate=True)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0, fill=0):
    """Pad `axis` to a multiple of `multiple` with `fill`; returns (padded,
    valid_mask (n + pad,) bool)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    mask = torch.as_tensor(np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]), device=x.device)
    if pad == 0:
        return x, mask
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=axis), mask


def shard_hypotheses(poses: torch.Tensor, mesh: DeviceMesh):
    """Pad the (N, 4, 4) hypotheses with identity poses to a multiple of
    the mesh size and split them over it. Returns (per-device poses,
    per-device valid masks); the padded rows are masked out of the
    ranking."""
    pad = (-poses.shape[0]) % mesh.size
    eye = torch.eye(4, dtype=poses.dtype, device=poses.device).expand(pad, 4, 4)
    poses = torch.cat([poses, eye])
    mask = torch.arange(poses.shape[0], device=poses.device) < poses.shape[0] - pad
    sh = batch_sharding(mesh)
    return sh(poses), sh(mask)


def _to(tree, dev: torch.device):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, nn.Module):
        src = next(iter(tree.parameters()), None)
        if src is not None and src.device == dev:
            return tree
        with torch.no_grad():
            rep = copy.deepcopy(tree).to(dev)
        # buffers that a trainer made leaves (BN statistics) stay trained
        for a, b in zip(rep.buffers(), tree.buffers()):
            a.requires_grad_(b.requires_grad)
        return rep
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple (MeshTensors)
        return type(tree)(*(_to(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree


def replicate_tree(tree, mesh: DeviceMesh) -> list:
    """One copy of `tree` per mesh device, in mesh order: tensors, modules
    (deep copies holding the module's current values; a module already on
    the device is returned itself), NamedTuples, lists, tuples and dicts
    of them. A device that repeats gets the same object. Nothing is
    cached: a caller replicates again after the tree changes."""
    per_device = {}
    for d in mesh.devices:
        if d not in per_device:
            per_device[d] = _to(tree, d)
    return [per_device[d] for d in mesh.devices]
