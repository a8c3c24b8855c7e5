"""The reference's register, tracking step and refiner training step, in
plain f32 torch.

From NVlabs/FoundationPose estimater.py:159-268 (register, track_one),
learning/training/predict_pose_refine.py:149-295 (crops, refinement,
the "tracknet" translation and axis-angle rotation updates) and
predict_score.py:160-226 (one comparison group): the depth is eroded and
bilaterally filtered (5x5), the hypotheses are the rotation grid at the
masked median depth along the mask box's center ray, each iteration
renders every hypothesis into its crop (a square around the projected
object, crop_ratio x the diameter, rounded to whole pixels), samples the
observation into the same crop (rgb bilinear, xyz nearest, zeros outside),
centers both xyz maps on the hypothesis and divides by the radius
(zero where depth < invalid_z or |xyz| >= 2), and applies the network's
delta. Training batches follow the same crops: the hypothesis and the
ground truth rendered into the hypothesis's crop, targets inverting the
update, l2 loss, Adam.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import geometry as G
from . import nets
from .render import render


@dataclasses.dataclass
class Mesh:
    """A mesh centered on its bounding box, as the estimator keeps it."""

    pos: torch.Tensor  # (V, 3)
    faces: torch.Tensor  # (F, 3)
    color: torch.Tensor  # (V, 3) in [0, 1]
    normals: torch.Tensor  # (V, 3)
    diameter: float
    center: torch.Tensor  # (3,) the bounding box's center, subtracted from pos

    @classmethod
    def from_arrays(cls, vertices, faces, colors_u8, device):
        import numpy as np

        v = np.asarray(vertices, np.float64)
        center = (v.min(0) + v.max(0)) / 2
        v = v - center
        t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
        return cls(t(v), t(faces, torch.int64), t(np.asarray(colors_u8, np.float32) / 255.0),
                   t(G.vertex_normals(v, faces)), G.diameter(v), t(center))


@dataclasses.dataclass(frozen=True)
class Crops:
    res: int = 160
    crop_ratio: float = 1.2
    invalid_z: float = 0.001  # the refiner's; the scorer's is 0.1
    cull: bool = True


def _windows(x, r, fill):
    H, W = x.shape
    xp = F.pad(x[None, None], (r,) * 4, value=fill)[0, 0]
    inb = F.pad(torch.ones_like(x)[None, None], (r,) * 4)[0, 0] > 0
    k = 2 * r + 1
    return (torch.stack([xp[i:i + H, j:j + W] for i in range(k) for j in range(k)]),
            torch.stack([inb[i:i + H, j:j + W] for i in range(k) for j in range(k)]))


def filter_depth(depth):
    """Erode (5x5; zero where over 80% of in-image neighbours are invalid or
    > 1 mm away), then bilateral (5x5, sigma_d 2 px; neighbours within
    1 cm of the local valid mean; holes filled)."""
    w, inb = _windows(depth, 2, 0.0)
    bad = (w < 0.001) | (w >= 100.0) | ((w - depth[None]).abs() > 0.001)
    frac = (inb & bad).float().sum(0) / inb.float().sum(0)
    depth = torch.where(frac > 0.8, torch.zeros_like(depth), depth)
    w, inb = _windows(depth, 2, 0.0)
    valid = inb & (w >= 0.001) & (w < 100.0)
    nv = valid.float().sum(0)
    mean = torch.where(valid, w, torch.zeros_like(w)).sum(0) / nv.clamp(min=1.0)
    off = torch.arange(5, dtype=torch.float32, device=depth.device) - 2
    dv, du = torch.meshgrid(off, off, indexing="ij")
    ws = torch.exp(-(du ** 2 + dv ** 2) / 8.0).reshape(25, 1, 1)
    wr = torch.exp(-((depth[None] - w) ** 2) / (2.0 * 1e10))
    wt = torch.where(valid & ((w - mean[None]).abs() < 0.01), ws * wr, torch.zeros_like(w))
    sw = wt.sum(0)
    out = (wt * w).sum(0) / sw.clamp(min=1e-12)
    return torch.where((sw > 0) & (nv > 0), out, torch.zeros_like(out))


def xyz_map(depth, K):
    H, W = depth.shape
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                          torch.arange(W, dtype=torch.float32, device=depth.device), indexing="ij")
    xyz = torch.stack([(u - K[0, 2]) * depth / K[0, 0], (v - K[1, 2]) * depth / K[1, 1], depth], -1)
    return torch.where((depth < 0.001)[..., None], torch.zeros_like(xyz), xyz)


def guess_center(depth, mask, K):
    """The mask box's center ray at the median of the valid masked depth."""
    m = mask > 0
    vs, us = torch.nonzero(m, as_tuple=True)
    uc = (us.min() + us.max()).float() / 2
    vc = (vs.min() + vs.max()).float() / 2
    vals = torch.sort(depth[m & (depth >= 0.001)]).values
    n = vals.numel()
    z = (vals[(n - 1) // 2] + vals[n // 2]) / 2
    return torch.stack([(uc - K[0, 2]) / K[0, 0] * z, (vc - K[1, 2]) / K[1, 1] * z, z])


def crop_tf(poses, K, ratio, res, diameter):
    """(N, 3, 3) affine from frame pixels to each pose's res x res crop; the
    radius in f32, as a program holding the diameter in f32 computes it."""
    r = torch.tensor(diameter, dtype=torch.float32, device=poses.device) * ratio / 2.0
    z = torch.zeros_like(r)
    off = torch.stack([torch.stack(v) for v in ((z, z, z), (r, z, z), (-r, z, z), (z, r, z), (z, -r, z))])
    p = poses[:, None, :3, 3] + off[None]
    uv = torch.stack([p[..., 0] * K[0, 0] / p[..., 2] + K[0, 2], p[..., 1] * K[1, 1] / p[..., 2] + K[1, 2]], -1)
    c = uv[:, 0]
    half = (uv - c[:, None]).abs().flatten(1).amax(1)
    left, right = torch.round(c[:, 0] - half), torch.round(c[:, 0] + half)
    top, bottom = torch.round(c[:, 1] - half), torch.round(c[:, 1] + half)
    sx, sy = res / (right - left), res / (bottom - top)
    tf = torch.zeros((poses.shape[0], 3, 3), device=poses.device)
    tf[:, 0, 0], tf[:, 0, 2] = sx, -left * sx
    tf[:, 1, 1], tf[:, 1, 2] = sy, -top * sy
    tf[:, 2, 2] = 1.0
    return tf


def sample(img, tf, res, mode):
    """img (H, W, C) at each crop's source coordinates -> (N, res, res, C);
    zeros outside the frame."""
    H, W, C = img.shape
    j = torch.arange(res, dtype=torch.float32, device=img.device)
    u = ((j[None] - tf[:, 0, 2, None]) / tf[:, 0, 0, None])[:, None, :].expand(-1, res, -1)
    v = ((j[None] - tf[:, 1, 2, None]) / tf[:, 1, 1, None])[:, :, None].expand(-1, -1, res)

    def tap(vi, ui):
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        val = img[vi.clamp(0, H - 1), ui.clamp(0, W - 1)]
        return torch.where(inb[..., None], val, torch.zeros_like(val))

    if mode == "nearest":
        return tap(torch.round(v).long(), torch.round(u).long())
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    ui, vi = u0.long(), v0.long()
    top = tap(vi, ui) * (1 - fu) + tap(vi, ui + 1) * fu
    bot = tap(vi + 1, ui) * (1 - fu) + tap(vi + 1, ui + 1) * fu
    return top * (1 - fv) + bot * fv


def center_xyz(xyz, poses, radius, invalid_z):
    out = (xyz - poses[:, None, None, :3, 3]) / radius
    bad = (xyz[..., 2:3] < invalid_z) | (out.abs() >= 2)
    return torch.where(bad, torch.zeros_like(out), out)


def crop_inputs(mesh: Mesh, poses, K, rgb, xyz, c: Crops):
    """Network inputs A (rendered) and B (observed), (N, res, res, 6)."""
    tf = crop_tf(poses, K, c.crop_ratio, c.res, mesh.diameter)
    col, rx, _ = render(mesh.pos, mesh.faces, mesh.color, mesh.normals, poses, K, (c.res, c.res), tf, c.cull)
    r = mesh.diameter / 2
    a = torch.cat([col, center_xyz(rx, poses, r, c.invalid_z)], -1)
    b = torch.cat([sample(rgb, tf, c.res, "bilinear"),
                   center_xyz(sample(xyz, tf, c.res, "nearest"), poses, r, c.invalid_z)], -1)
    return a, b


def apply_delta(poses, trans, rot, diameter, rot_normalizer):
    """Translation delta trans x radius; rotation so3_exp(tanh(rot) x
    rot_normalizer)^T applied on the left."""
    dR = G.so3_exp(torch.tanh(rot) * rot_normalizer).transpose(-1, -2)
    return G.make_pose(dR @ poses[:, :3, :3], poses[:, :3, 3] + trans * (diameter / 2))


@dataclasses.dataclass
class Estimator:
    """The reference estimator: nets' state dicts and the configuration."""

    mesh: Mesh
    refiner: dict
    scorer: dict
    heads: int = 4
    refine_crops: Crops = Crops()
    score_crops: Crops = Crops(invalid_z=0.1)
    rot_normalizer: float = 0.34906585
    quant: str | None = None
    block: int = 64  # hypotheses a network call

    def __post_init__(self):
        nets.plain_numerics()

    def refine(self, poses, K, rgb, xyz, iterations):
        for _ in range(iterations):
            new = []
            for s in range(0, poses.shape[0], self.block):
                p = poses[s:s + self.block]
                a, b = crop_inputs(self.mesh, p, K, rgb, xyz, self.refine_crops)
                t, r = nets.refine_net(self.refiner, a, b, self.heads, self.quant)
                new.append(apply_delta(p, t, r, self.mesh.diameter, self.rot_normalizer))
            poses = torch.cat(new)
        return poses

    def score(self, poses, K, rgb, xyz, valid):
        feats = []
        for s in range(0, poses.shape[0], self.block):
            a, b = crop_inputs(self.mesh, poses[s:s + self.block], K, rgb, xyz, self.score_crops)
            feats.append(nets.score_pooled(self.scorer, a, b, self.heads, self.quant))
        logits = nets.score_logits(self.scorer, torch.cat(feats), self.heads, self.quant)
        return torch.where(valid, logits, torch.full_like(logits, float("-inf")))

    @torch.no_grad()
    def register(self, K, rgb_u8, depth, mask, rot_grid, valid, iterations):
        """-> (refined (N, 4, 4) in grid order, logits (N,)), centered-mesh
        frame."""
        rgb = rgb_u8.float() / 255.0
        d = filter_depth(depth)
        xyz = xyz_map(d, K)
        poses = rot_grid.clone()
        poses[:, :3, 3] = guess_center(d, mask, K)[None]
        refined = self.refine(poses, K, rgb, xyz, iterations)
        return refined, self.score(refined, K, rgb, xyz, valid)

    @torch.no_grad()
    def judge(self, poses, K, rgb_u8, depth, valid):
        """The scorer's logits of another estimator's poses on a frame: the
        reference reading an answer to judge it."""
        return self.score(poses, K, rgb_u8.float() / 255.0, xyz_map(filter_depth(depth), K), valid)

    @torch.no_grad()
    def track(self, pose, K, rgb_u8, depth, iterations):
        rgb = rgb_u8.float() / 255.0
        return self.refine(pose[None], K, rgb, xyz_map(filter_depth(depth), K), iterations)[0]


def pose_pairs(draws, center_dist=0.8, trans_sigma=0.01, rot_sigma=0.15):
    """Training pairs from normal draws w_gt, t_gt, dw, dt (n, 3):
    (hypothesis, ground truth)."""
    R = G.so3_exp(draws["w_gt"] * 1.5)
    n = draws["t_gt"]
    t = torch.stack([n[:, 0] * 0.05, n[:, 1] * 0.05, n[:, 2] * 0.1 + center_dist], -1)
    gt = G.make_pose(R, t)
    hyp = G.make_pose(G.so3_exp(draws["dw"] * rot_sigma) @ R, t + draws["dt"] * trans_sigma)
    return hyp, gt


def refiner_batch(mesh: Mesh, K, draws, c: Crops, rot_normalizer=0.34906585):
    """Both poses rendered into the hypothesis's crop, targets in the
    network's output space (clipped at +-0.999 before atanh)."""
    hyp, gt = pose_pairs(draws)
    tf = crop_tf(hyp, K, c.crop_ratio, c.res, mesh.diameter)
    r = mesh.diameter / 2
    ab = []
    for p in (hyp, gt):
        col, xyz, _ = render(mesh.pos, mesh.faces, mesh.color, mesh.normals, p, K, (c.res, c.res), tf, c.cull)
        ab.append(torch.cat([col, center_xyz(xyz, hyp, r, c.invalid_z)], -1))
    dt = gt[:, :3, 3] - hyp[:, :3, 3]
    dR = gt[:, :3, :3] @ hyp[:, :3, :3].transpose(-1, -2)
    w = G.so3_log(dR.transpose(-1, -2))
    return {"A": ab[0], "B": ab[1], "trans_target": dt / r,
            "rot_target": torch.arctanh(torch.clamp(w / rot_normalizer, -0.999, 0.999))}


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), in place on f32
    leaves."""

    def __init__(self, leaves: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def step(self, leaves: dict, grads: dict):
        self.t += 1
        for k, g in grads.items():
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            mhat = self.m[k] / (1 - 0.9 ** self.t)
            vhat = self.v[k] / (1 - 0.999 ** self.t)
            leaves[k].sub_(self.lr * mhat / (vhat.sqrt() + 1e-8))


def refine_loss(params, batch, heads, quant=None):
    t, r = nets.refine_net(params, batch["A"], batch["B"], heads, quant)
    return ((t - batch["trans_target"]) ** 2).mean() + ((r - batch["rot_target"]) ** 2).mean()


def train_steps(state: dict, mesh: Mesh, K, draws_list, c: Crops, lr, heads, quant=None, moments=None):
    """Refiner training from `state` (every float tensor a trained leaf,
    BN statistics included) over one batch a step, with a fresh Adam or
    one holding `moments` (first and second moments by name, step count).
    -> (losses, first gradients, final leaves)."""
    nets.plain_numerics()
    leaves = {k: v.detach().clone().float() for k, v in state.items() if v.is_floating_point()}
    opt = Adam(leaves, lr)
    if moments is not None:
        m, v, opt.t = moments
        opt.m = {k: m[k].detach().clone().float() for k in leaves}
        opt.v = {k: v[k].detach().clone().float() for k in leaves}
    losses, first = [], None
    for draws in draws_list:
        with torch.no_grad():
            batch = refiner_batch(mesh, K, draws, c)
        p = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        loss = refine_loss(p, batch, heads, quant)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()), allow_unused=True)))
        grads = {k: (g if g is not None else torch.zeros_like(leaves[k])) for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(leaves, grads)
    return losses, first, leaves
