"""The neural object field's training step of the reference, in plain f32
torch.

From NVlabs/FoundationPose's model-free setup (bundlesdf/run_nerf.py:18-73,
bundlesdf/nerf_runner.py, bundlesdf/config_ycbv.yml), whose field is
BundleSDF's (arXiv:2303.14158) over Instant-NGP's multi-resolution hash
grid (arXiv:2201.05989). One step:

- a batch of rays (rows of the ray pool); each ray's frame pose corrected
  by that frame's learned SE(3), tanh-bounded to max_trans (normalized by
  the scene's scale) and max_rot degrees, frame 0 pinned (PoseArray);
- n_samples samples in occupied space from candidate_mult x n_samples
  stratified candidates, n_samples_around_depth in the truncation band
  around the ray's depth, both from the given uniforms;
- the hash grid (16 levels, 2 features, trilinear over the cell's eight
  corners) read in f32, degree-3 spherical harmonics of the view with the
  frame's learned features, NeRFSmall (sigma 32-64-16, colour 26-64-64-3);
- BundleSDF's band weights sigmoid(l s) sigmoid(-l s) over the band, the
  rgb, free-space, empty, truncated-SDF and feature-regularisation losses;
- gradients by autograd, the global-norm clip, Adam (b1 0.9, b2 0.999,
  eps 1e-15, bias-corrected) at lrate * decay_rate ** (count / n_step).

Departures from BundleSDF, each also the program's configuration:
- a dense boolean occupancy grid stands for kaolin's octree, and its
  samples are the rank-selected occupied ones of the candidates along the
  occupied span that coarse probes find (BundleSDF samples its octree's
  intersected voxels);
- the grid's corner addressing is "oct": corner (dx, dy, dz) of the cell
  at (x, y, z) is row (x + dx + s (y + dy) + h (z + dz)) mod the level's
  size, s = resolution + 1, h = s^2 on a level stored densely and
  805459861 on a hashed one, where torch-ngp XORs the products of the
  three coordinates with its primes; the interpolation, resolutions and
  table sizes are torch-ngp's;
- only the five loss terms of config_ycbv.yml (its other terms are off);
- x01 * scale + 0.5 is rounded once, as a fused multiply-add rounds it,
  and the truncation is the f32 product of the f32 band and scale.

Given data, as the weights are: the ray pool of set-up (each masked
pixel's direction, colour, depth and frame, after the denoise against the
fused cloud), the occupancy grid, the frames' normalized poses and the
scene's scale, and each step's draws (batch rows and the two jitters).

`quant="fp8"` reads the table and computes every linear layer with inputs
and weights rounded to float8 e4m3 (nets._Fp8: one scale per tensor,
gradients passed unchanged): the control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry as G
from . import nets

B1, B2, EPS = 0.9, 0.999, 1e-15
H_PRIME = 805459861
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
MLP_LAYERS = ("mlp.sigma.0", "mlp.sigma.1", "mlp.color.0", "mlp.color.1", "mlp.color.2")


def level_tables(c: dict):
    """Per level: resolution, rows and first row; and the rows in all."""
    L = c["num_levels"]
    scale_step = np.log2(np.exp2(np.log2(c["finest_res"] / c["base_res"]) / max(L - 1, 1)))
    res, sizes, offsets, total = [], [], [], 0
    for lv in range(L):
        r = int(np.ceil(np.exp2(lv * scale_step) * c["base_res"] - 1.0)) + 1
        size = int(np.ceil(min(2 ** c["log2_hashmap_size"], (r + 1) ** 3) / 8) * 8)
        res.append(r)
        sizes.append(size)
        offsets.append(total)
        total += size
    return res, sizes, offsets, total


def _q(x, quant):
    return nets._Fp8.apply(x) if quant == "fp8" else x


def encode(table, x, c: dict, quant=None):
    """table (T, C), x (P, 3) in [-1, 1] -> (P, L * C), level-major; points
    outside the cube read zeros."""
    res, sizes, offsets, _ = level_tables(c)
    L = len(res)
    dev = x.device
    scale_step = np.log2(np.exp2(np.log2(c["finest_res"] / c["base_res"]) / max(L - 1, 1)))
    scales = torch.tensor([np.exp2(lv * scale_step) * c["base_res"] - 1.0 for lv in range(L)],
                          dtype=torch.float32, device=dev)
    s = torch.tensor(res, device=dev) + 1
    h = torch.where(s ** 3 <= torch.tensor(sizes, device=dev), s * s, H_PRIME)
    size = torch.tensor(sizes, device=dev)
    off = torch.tensor(offsets, device=dev)
    x01 = (x + 1.0) / 2.0
    outside = ((x01 < 0.0) | (x01 > 1.0)).any(-1)
    pos = (x01[:, :, None].double() * scales.double() + 0.5).float()  # (P, 3, L)
    cell = torch.floor(pos)
    frac = pos - cell
    cell = cell.long()
    t = _q(table, quant)
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                row = ((cell[:, 0] + dx) + s * (cell[:, 1] + dy) + h * (cell[:, 2] + dz)) % size + off
                w = ((frac[:, 0] if dx else 1 - frac[:, 0]) * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                out = out + w[..., None] * t[row]  # (P, L, C)
    return torch.where(outside[:, None, None], 0.0, out).reshape(len(x), -1)


def sh3(d):
    """Real spherical harmonics of degrees 0-2 (nine) of unit directions."""
    x, y, z = d.unbind(-1)
    return torch.stack([torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
                        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * z * z - x * x - y * y),
                        SH_C2[3] * x * z, SH_C2[4] * (x * x - y * y)], -1)


def _linear(p, name, x, quant):
    return _q(x, quant) @ _q(p[name + ".weight"], quant).T + p[name + ".bias"]


def field(p, emb, views, quant=None):
    """NeRFSmall: emb (P, L C), views (P, 9 + features) -> rgb logits (P, 3),
    sdf (P,)."""
    h = _linear(p, MLP_LAYERS[1], torch.relu(_linear(p, MLP_LAYERS[0], emb, quant)), quant)
    c = torch.cat([views, h[:, 1:]], -1)
    for name in MLP_LAYERS[2:4]:
        c = torch.relu(_linear(p, name, c, quant))
    return _linear(p, MLP_LAYERS[4], c, quant), h[:, 0]


def frame_corrections(pose, max_trans, max_rot_deg):
    """(F, 6) -> (F, 4, 4): exp of the tanh-bounded translation and rotation
    tangents (SE(3): R = exp(w), t = V(w) v), frame 0 the identity."""
    th = torch.tanh(pose)
    v = th[:, :3] * max_trans
    w = th[:, 3:] * max_rot_deg / 180.0 * math.pi
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    a = torch.sqrt(t2s)
    A = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(a)) / t2s)
    B = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (a - torch.sin(a)) / (a * t2s))
    K = G.hat(w)
    V = torch.eye(3, device=pose.device) + A[:, None, None] * K + B[:, None, None] * (K @ K)
    T = G.make_pose(G.so3_exp(w), (V @ v[:, :, None])[..., 0])
    return torch.cat([torch.eye(4, device=pose.device)[None], T[1:]])


def _occupied(occ, pts):
    n = occ.shape[0]
    i = torch.floor((pts + 1.0) / (2.0 / n)).long()
    inside = ((i >= 0) & (i < n)).all(-1)
    i = i.clamp(0, n - 1)
    return occ[i[..., 0], i[..., 1], i[..., 2]] & inside


def sample_occupied(occ, o, d, n, u, depth, trunc, far, mult):
    """n samples a ray in occupied space -> (z (R, n), valid (R, n)): the ray
    inside the cube, cut at its depth + trunc where it has one; n coarse
    probes find the occupied span (grown by a probe's spacing); mult x n
    candidates stratified over it by u; the n occupied candidates of evenly
    spaced ranks."""
    inv = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
    t0, t1 = (-1.0 - o) * inv, (1.0 - o) * inv
    tmin = torch.minimum(t0, t1).amax(-1).clamp(min=0.0)
    tmax = torch.maximum(t0, t1).amin(-1)
    hit = tmax > tmin
    has_d = (depth > 1e-6) & (depth <= far)
    tend = torch.maximum(torch.where(has_d, torch.minimum(tmax, depth + trunc), tmax), tmin + 1e-6)

    def along(t):
        return _occupied(occ, o[:, None] + d[:, None] * t[..., None]) & hit[:, None]

    tc = tmin[:, None] + (tend - tmin)[:, None] * ((torch.arange(n, device=o.device)[None] + 0.5) / n)
    probe = along(tc)
    found = probe.any(-1)
    spacing = (tend - tmin) / n
    lo = torch.where(found, torch.maximum(torch.where(probe, tc, 1e30).amin(-1) - spacing, tmin), tmin)
    hi = torch.where(found, torch.minimum(torch.where(probe, tc, -1e30).amax(-1) + spacing, tend), tend)
    M = mult * n
    cand = lo[:, None] + (hi - lo)[:, None] * ((torch.arange(M, device=o.device)[None] + u) / M)
    occ_c = along(cand)
    count = occ_c.sum(-1)
    rank = torch.floor((torch.arange(n, device=o.device)[None] + 0.5) * count[:, None].float() / n).int() + 1
    pick = torch.searchsorted(torch.cumsum(occ_c.int(), -1).int(), rank).clamp(0, M - 1)
    valid = (torch.arange(n, device=o.device)[None] < count.clamp(max=n)[:, None]) & hit[:, None]
    return torch.where(valid, torch.gather(cand, 1, pick), tend[:, None]), valid


def truncation(c: dict, sc: float) -> float:
    return float(np.float32(c["trunc"]) * np.float32(sc))


def block_loss(p, data, rows, u_occ, u_depth, c, n_total, quant=None):
    """The loss terms of rays `rows` of a batch of n_total rays, each term's
    mean over the whole batch (so blocks add up): rgb, free space, empty,
    truncated SDF; the feature regularisation is not a ray's."""
    sc = data["sc_factor"]
    trunc, near, far = truncation(c, sc), c["near"] * sc, c["far"] * sc
    dirs, depth, fid, target = (data[k][rows] for k in ("dir", "depth", "frame_id", "rgb"))
    R = len(rows)
    tf = frame_corrections(p["pose"], c["max_trans"] * sc, c["max_rot"])[fid] @ data["c2w"][fid]
    o = tf[:, :3, 3]
    d = (tf[:, :3, :3] @ dirs[:, :, None])[..., 0]
    z, valid = sample_occupied(data["occ"], o, d, c["n_samples"], u_occ, depth, trunc, far, c["candidate_mult"])
    S2 = c["n_samples_around_depth"]
    lo, hi = depth - trunc, depth + trunc * c["neg_trunc_ratio"]
    z = torch.cat([z, lo[:, None] + (hi - lo)[:, None] * ((torch.arange(S2, device=o.device)[None] + u_depth) / S2)], -1)
    has_d = (depth >= near) & (depth <= far)
    valid = torch.cat([valid, has_d[:, None].expand(R, S2)], -1)
    S = z.shape[1]
    pts = o[:, None] + d[:, None] * z[..., None]
    valid = valid & (pts.abs() <= 1.0).all(-1)
    views = torch.cat([sh3(d / torch.linalg.norm(d, dim=-1, keepdim=True)), p["features"][fid]], -1)
    emb = encode(p["grid"], pts.reshape(-1, 3), c, quant)
    logits, sdf = field(p, emb, views[:, None].expand(R, S, views.shape[-1]).reshape(R * S, -1), quant)
    logits, sdf = logits.reshape(R, S, 3), sdf.reshape(R, S)

    dd = depth[:, None]
    s = (dd - z) / trunc
    w = torch.sigmoid(s * c["sdf_lambda"]) * torch.sigmoid(-s * c["sdf_lambda"])
    band = (z - dd <= trunc * c["neg_trunc_ratio"]) & (z - dd >= -trunc) & (dd <= far) & valid
    w = torch.where(band, w, 0.0)
    w = w / (w.sum(-1, keepdim=True) + 1e-10)
    rgb = (w[..., None] * torch.sigmoid(logits)).sum(-2)

    ray_w = torch.where(fid == 0, c["first_frame_weight"], 1.0) * valid.any(-1)
    sample_w = ray_w[:, None] * valid
    front = z < dd - trunc
    back = z > dd + trunc * c["neg_trunc_ratio"]
    in_band = ~front & ~back & (dd >= near) & (dd <= far)
    per_ray, per_sample = n_total * 3, n_total * S
    fs = (dd > far) & (sdf < c["fs_sdf"])
    empty = front & (dd <= far) & (sdf < 1)
    return (c["rgb_weight"] * (((rgb - target) ** 2) * ray_w[:, None]).sum() / per_ray
            + (((sdf - c["fs_sdf"]) * fs) ** 2 * sample_w).sum() / per_sample * 0.5 * c["fs_weight"]
            + ((sdf - 1).abs() * empty * sample_w).sum() / per_sample * c["empty_weight"]
            + (((z + sdf * trunc) * in_band - dd * in_band) ** 2 * sample_w).sum() / per_sample
            * 0.5 * c["trunc_weight"])


def loss_and_grads(params, data, draws, c, quant=None, block=512):
    """One batch: the loss and every leaf's gradient, the rays taken in
    blocks of `block` (each block's backward adds into the gradients)."""
    rows, u_occ, u_depth = draws
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = 0.0
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    reg = c["feature_reg_weight"] * (p["features"] ** 2).mean()
    parts = [(reg, None)] + [(None, slice(b, b + block)) for b in range(0, len(rows), block)]
    for loss, blk in parts:
        if loss is None:
            loss = block_loss(p, data, rows[blk], u_occ[blk], u_depth[blk], c, len(rows), quant)
        for k, g in zip(p, torch.autograd.grad(loss, list(p.values()), allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
    return total, grads


@torch.no_grad()
def clip_adam(params, grads, state, c):
    """The global-norm clip, then Adam at lrate * decay_rate ** (count /
    n_step), in place; state = (mu, nu, count). -> the clipped gradients."""
    mu, nu, count = state
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    factor = torch.where(norm < c["gradient_max_norm"], 1.0, c["gradient_max_norm"] / norm)
    lr = c["lrate"] * c["decay_rate"] ** (count / c["n_step"])
    c1, c2 = 1.0 - B1 ** (count + 1), 1.0 - B2 ** (count + 1)
    clipped = {}
    for k, g in grads.items():
        g = g * factor
        clipped[k] = g
        mu[k].mul_(B1).add_(g, alpha=1 - B1)
        nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
        params[k].sub_(lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS))
    return clipped


def train_steps(params: dict, data: dict, draws_list: list, c: dict, quant=None, moments=None, block=512):
    """Steps from `params` (by the program's parameter names) over one
    batch of draws a step, with fresh Adam moments or `moments` = (mu, nu,
    count). -> (losses, the first step's clipped gradients, final params)."""
    nets.plain_numerics()
    params = {k: v.detach().clone().float() for k, v in params.items()}
    if moments is None:
        mu, nu = ({k: torch.zeros_like(v) for k, v in params.items()} for _ in range(2))
        count = 0
    else:
        mu, nu = ({k: v.detach().clone().float() for k, v in m.items()} for m in moments[:2])
        count = int(moments[2])
    losses, first = [], None
    for draws in draws_list:
        loss, grads = loss_and_grads(params, data, draws, c, quant, block)
        clipped = clip_adam(params, grads, (mu, nu, count), c)
        count += 1
        first = clipped if first is None else first
        losses.append(loss)
    return losses, first, params
