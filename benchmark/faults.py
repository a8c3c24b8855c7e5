"""Faults planted under a cell's timed path, to show that `correct` catches
them: each patches the program for the duration of a `with` block.

- `unchanged`: the step returns its state unchanged (a register's or a
  tracked frame's refinement returns its input poses; a training step
  skips the optimizer's update);
- `half_batch`: half of the batch left out (a register refines only the
  first half of its hypotheses; a training step takes the loss's mean over
  the first half of its pairs);
- `altered`: an answer altered where it is produced (every refined pose
  moved by 1 mm along x; a training step's loss scaled by 1.5 before its
  backward pass).
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(kind: str, fault: str):
    from foundationpose_torch.models import training
    from foundationpose_torch.pipeline import graph

    refine, loss_fn, step = graph.refine_poses, training.refine_loss_fn, training._step

    def refine_fault(net, cfg, mesh, poses, *args, **kw):
        if fault == "unchanged":
            return poses.clone()
        if fault == "half_batch":
            h = poses.shape[0] // 2
            return torch.cat([refine(net, cfg, mesh, poses[:h], *args, **kw), poses[h:]])
        out = refine(net, cfg, mesh, poses, *args, **kw).clone()
        out[:, 0, 3] += 1e-3
        return out

    def loss_fault(module, batch, loss_type, dtype):
        if fault == "half_batch":
            h = batch["A"].shape[0] // 2
            return loss_fn(module, {k: v[:h] for k, v in batch.items()}, loss_type, dtype)
        return loss_fn(module, batch, loss_type, dtype) * 1.5

    def step_fault(optimizer, loss_of):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of()
        loss.backward()
        return loss.detach()

    patches = []
    if kind in ("register", "track"):
        patches.append((graph, "refine_poses", refine_fault))
    elif fault == "unchanged":
        patches.append((training, "_step", step_fault))
    else:
        patches.append((training, "refine_loss_fn", loss_fault))
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        graph.refine_poses, training.refine_loss_fn, training._step = refine, loss_fn, step
