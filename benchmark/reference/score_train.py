"""The scorer's training step of the reference, in plain f32 torch: one
hypothesis group around a ground-truth pose, ScoreNetMultiPair's logits
over it, the group's softmax cross-entropy against ADD-derived soft
targets, its gradients by autograd, and Adam.

From NVlabs/FoundationPose learning/models/score_network.py (the network:
`nets.score_pooled`, `nets.score_logits`) and
learning/training/predict_score.py:160-226 (one comparison group: every
hypothesis rendered into its crop, the observation sampled into the same
crop, the crops' xyz centered on the hypothesis and divided by the
radius, zero where z < 0.1). The ground truth and its hypotheses are drawn
from normals: the ground truth as a training pair's (`pipeline.pose_pairs`,
0.8 m away), hypothesis i of n turned by so3_exp(dw_i rot_sigma s_i) and
moved by dt_i trans_sigma s_i, s_i = i / (n - 1), so the first is exact
and the last at the registration grid's scale. The target of a hypothesis
is -ADD / (0.05 diameter), ADD the mean distance of the mesh's vertices
under it and under the ground truth; the loss is
-(softmax(target) . log_softmax(logits)), summed over the group.

Departures from predict_score.py, which scores but does not train (the
reference released no training code; the recipe is that of the JAX
package's `make_scorer_batch` and `score_loss_fn`):
- the observation is the mesh rendered at the ground truth by the plain
  renderer (`render.py`): colors in [0, 1] not rounded to bytes, xyz the
  render's own, with no sensor depth and no depth filter;
- no occluder is pasted on the frame, and no augmentation;
- the targets are the soft ADD logits above, not a ranking by pose error;
- the observed xyz is sampled nearest at (1 / s) j + (-t (1 / s)), the
  crop's scale s inverted first, as the JAX package inverts the crop's
  transform (kornia's warp in the released code inverts the whole matrix
  and normalizes the grid): at 160 px over an even box width every other
  source column lies on .5, and `pipeline.sample`'s (j - t) / s sends a
  few hundred pixels of a crop to the other neighbour of the tie.
Imports nothing of the program. TF32 is off (`nets.plain_numerics`).
"""
from __future__ import annotations

import torch

from . import geometry as G
from . import nets
from .pipeline import Adam, Crops, Mesh, center_xyz, crop_tf, pose_pairs, sample
from .render import render


def group_poses(draws: dict, n: int, rot_sigma: float, trans_sigma: float, center_m: float = 0.8):
    """(hypotheses (n, 4, 4), ground truth (4, 4)) from the normal draws
    'scene' (w_gt, t_gt, dw, dt of one pair: its ground truth is the
    group's), 'dw' and 'dt' (n, 3)."""
    gt = pose_pairs(draws["scene"], center_m)[1][0]
    scales = (torch.arange(n, dtype=torch.float32, device=gt.device) / max(n - 1, 1))[:, None]
    dR = G.so3_exp(draws["dw"] * rot_sigma * scales)
    return G.make_pose(dR @ gt[:3, :3], gt[:3, 3] + draws["dt"] * trans_sigma * scales), gt


def nearest(img, tf, res):
    """img (H, W, C) at each crop's source pixels, the nearest, the scale
    inverted first -> (N, res, res, C); zeros outside the frame."""
    H, W, _ = img.shape
    j = torch.arange(res, dtype=torch.float32, device=img.device)
    ix, iy = 1.0 / tf[:, 0, 0], 1.0 / tf[:, 1, 1]
    u = torch.round(ix[:, None] * j[None] + (-tf[:, 0, 2] * ix)[:, None]).long()[:, None, :].expand(-1, res, -1)
    v = torch.round(iy[:, None] * j[None] + (-tf[:, 1, 2] * iy)[:, None]).long()[:, :, None].expand(-1, -1, res)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    val = img[v.clamp(0, H - 1), u.clamp(0, W - 1)]
    return torch.where(inb[..., None], val, torch.zeros_like(val))


def crops(mesh: Mesh, poses, K, rgb, xyz, c: Crops):
    """pipeline.crop_inputs with the observed xyz sampled by `nearest`:
    network inputs A (rendered) and B (observed), (N, res, res, 6)."""
    tf = crop_tf(poses, K, c.crop_ratio, c.res, mesh.diameter)
    col, rx, _ = render(mesh.pos, mesh.faces, mesh.color, mesh.normals, poses, K, (c.res, c.res), tf, c.cull)
    r = mesh.diameter / 2
    a = torch.cat([col, center_xyz(rx, poses, r, c.invalid_z)], -1)
    b = torch.cat([sample(rgb, tf, c.res, "bilinear"), center_xyz(nearest(xyz, tf, c.res), poses, r, c.invalid_z)], -1)
    return a, b


@torch.no_grad()
def group_batch(mesh: Mesh, K, draws: dict, n: int, rot_sigma: float, trans_sigma: float, hw, c: Crops,
                center_m: float = 0.8) -> dict:
    """One group: the frame (hw) rendered at the ground truth, the
    hypotheses' crops A (rendered) and B (observed), (n, res, res, 6), and
    the targets (n,)."""
    hyp, gt = group_poses(draws, n, rot_sigma, trans_sigma, center_m)
    col, xyz, _ = render(mesh.pos, mesh.faces, mesh.color, mesh.normals, gt[None], K, tuple(hw), None, c.cull)
    a, b = crops(mesh, hyp, K, col[0], xyz[0], c)
    pts_h = torch.einsum("nij,pj->npi", hyp[:, :3, :3], mesh.pos) + hyp[:, None, :3, 3]
    pts_g = mesh.pos @ gt[:3, :3].T + gt[:3, 3]
    add = torch.linalg.norm(pts_h - pts_g[None], dim=-1).mean(-1)
    return {"A": a, "B": b, "target": -add / (0.05 * mesh.diameter)}


def group_loss(params: dict, batch: dict, heads: int, quant=None):
    feats = nets.score_pooled(params, batch["A"], batch["B"], heads, quant)
    logits = nets.score_logits(params, feats, heads, quant)
    return -(torch.softmax(batch["target"], -1) * torch.log_softmax(logits, -1)).sum()


def train_steps(state: dict, batches: list, lr: float, heads: int, quant=None, moments=None):
    """Scorer training from `state` (every float tensor a trained leaf, BN
    statistics included) over one group a step (`group_batch`'s), with a
    fresh Adam or one holding `moments` (first and second moments by name,
    step count). -> (losses, first gradients, final leaves)."""
    nets.plain_numerics()
    leaves = {k: v.detach().clone().float() for k, v in state.items() if v.is_floating_point()}
    opt = Adam(leaves, lr)
    if moments is not None:
        m, v, opt.t = moments
        opt.m = {k: m[k].detach().clone().float() for k in leaves}
        opt.v = {k: v[k].detach().clone().float() for k in leaves}
    losses, first = [], None
    for batch in batches:
        p = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        loss = group_loss(p, batch, heads, quant)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()), allow_unused=True)))
        grads = {k: (g if g is not None else torch.zeros_like(leaves[k])) for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(leaves, grads)
    return losses, first, leaves
