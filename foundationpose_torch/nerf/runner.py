"""Neural-object-field training and mesh extraction on torch tensors.

Port of foundationpose_tpu/nerf/runner.py (reference
bundlesdf/nerf_runner.py) with every option of NerfCfg: ray records from
posed RGB-D frames, occupancy-grid sampling with near-band subsetting
(`occ_keep_frac`) and importance resampling (`n_importance`), the
hash-grid encoder (ops/hashgrid.py, whose backward runs K3 or K4 on the
card), the NeRFSmall MLP, the SDF losses (nerf_runner.py:507-680) with
the annealed truncation and the depth, free-space rgb and eikonal terms,
one train step through autograd, train-state checkpoints and resume,
artifact dumps, `render_frame`, and marching-tetrahedra extraction.

The optimizer is optax's chain written out: clip_by_global_norm, Adam
(b1 0.9, b2 0.999, eps 1e-15, bias-corrected) and the learning rate
lrate * decay_rate ** (count / n_step), count being the number of
updates already applied.

Random draws come from a `torch.Generator` on the runner's device; `step`
(one step of `train`) seeds it from (seed, step) before each step, as the
JAX package folds the step into its key, so a resumed run draws what an
uninterrupted one does; `step_draws` gives a step's draws again.
The render and the train step also take the draws themselves (`draw`:
batch indices, the occupancy jitter, the around-depth jitter, the
importance uniforms and the near-band tie jitter) so that tests can pin
them. On a CUDA device the host runs only what the JAX package runs on the
host: ray building, the denoise, the sample grid of the extraction,
marching tetrahedra and the artifact files.

While the recorder records (utils/profiling.py), a train step is a
request of kind "nerf": the host span `nerf.step` around its dispatch,
the device stages `nerf.sample` (batch gather, frame corrections, both
samplers), `nerf.encode` (the hash-grid forward), `nerf.mlp` (the MLP,
band weights and losses), `nerf.backward` (autograd's backward, less the
table gradient), `nerf.grid_backward` (the table gradient, marked inside
the encoder's backward, ops/hashgrid.py) and `nerf.adam` (clip and
update), and the counter `nerf.points`, the points encoded.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch
from scipy import ndimage
from torch import nn

from .. import torch_config
from ..meshio import TriMesh
from ..ops.hashgrid import LAYOUTS, HashGridCfg, hashgrid_encode, init_hashgrid
from ..ops.marching import marching_tetrahedra
from ..utils import profiling
from ..utils.checkpoint import load_train_state, save_train_state
from .config import NerfCfg
from .model import init_nerf_mlp, pose_array_matrices, sh_encode
from .occupancy import build_occupancy_grid, occupancy_lookup, sample_occupied
from .scene import BAD_DEPTH

logger = logging.getLogger(__name__)


def check_supported(cfg: NerfCfg) -> None:
    """Raise NotImplementedError for a grid layout that neither package has
    (every NerfCfg option is ported)."""
    if cfg.grid_layout not in LAYOUTS:
        raise NotImplementedError(
            f"NerfCfg grid_layout {cfg.grid_layout!r} is unknown (layouts: {', '.join(LAYOUTS)})"
        )


def sample_pdf(bins, weights, n_samples, u=None):
    """Inverse-CDF resampling (nerf_helpers.py:358-385): bins (N, B),
    weights (N, B-1) -> (N, n_samples) z values from the piecewise-constant
    pdf over the bins. `u` (N, n_samples) uniforms; None takes
    linspace(0, 1) for every ray (the JAX package's perturb=False)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    N = bins.shape[0]
    if u is None:  # jnp.linspace(0, 1, n): i / (n - 1), rounded once
        u = (torch.arange(n_samples, dtype=torch.float32, device=bins.device) / max(n_samples - 1, 1))
        u = u.expand(N, n_samples)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    bins_b = torch.gather(bins, 1, torch.clamp(below, max=bins.shape[-1] - 1))
    bins_a = torch.gather(bins, 1, torch.clamp(above, max=bins.shape[-1] - 1))
    denom = torch.where(cdf_a - cdf_b < 1e-5, 1.0, cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def subset_near_band(z, valid, depth, trunc, neg_trunc_ratio, keep, u, near=None, far=None):
    """Keep the `keep` samples per ray nearest the depth band
    [depth - trunc, depth + trunc * neg_trunc_ratio] (NerfCfg.occ_keep_frac):
    in-band samples first, their ties broken by the jitter u (N, S) * 1e-5,
    then out-of-band ones by distance, invalid ones last; rays without
    usable depth (outside [near, far]) keep a random subset. The kept
    samples stay in ascending index order. A stable descending sort takes
    the lower index first on a tie, as jax.lax.top_k does (torch.topk gives
    no tie order on CUDA). Returns (z_kept, valid_kept)."""
    lo = depth[:, None] - trunc
    hi = depth[:, None] + trunc * neg_trunc_ratio
    dist = torch.clamp(lo - z, min=0.0) + torch.clamp(z - hi, min=0.0)
    if near is not None:
        has_d = (depth >= near) & (depth <= far)
        dist = torch.where(has_d[:, None], dist, 0.0)
    rank = torch.where(valid, -dist - u * 1e-5, -torch.inf)
    idx = torch.sort(torch.argsort(rank, dim=-1, descending=True, stable=True)[:, :keep], dim=-1).values
    return torch.gather(z, 1, idx), torch.gather(valid, 1, idx)


def _step_seed(seed: int, it: int) -> int:
    """The generator seed of step `it` of a run seeded with `seed`."""
    return (int(seed) * 1_000_003 + int(it)) % (2**63)


def make_frame_rays(rgb, depth, mask, K, frame_id, dilate=0):
    """Per-frame ray records (nerf_runner.py:247-317, CV convention): numpy
    dir (N, 3) with z = 1, rgb (N, 3), depth (N,), frame_id (N,), one per
    mask pixel. `dilate` grows the mask over a dilate x dilate window at
    offsets -dilate//2 .. (dilate-1)//2, as cv2.dilate's centred kernel."""
    m = mask.astype(bool)
    if dilate > 0:
        m = ndimage.maximum_filter(m, size=dilate, mode="constant", cval=0)
    v, u = np.nonzero(m)
    dirs = np.stack(
        [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u, np.float64)], axis=-1
    )
    return {
        "dir": dirs.astype(np.float32),
        "rgb": rgb[v, u].astype(np.float32),
        "depth": depth[v, u].astype(np.float32),
        "frame_id": np.full(len(v), frame_id, np.int32),
    }


def init_opt_state(params: dict) -> dict:
    """Adam state: update count and first / second moments by name."""
    return {
        "count": 0,
        "mu": {n: torch.zeros_like(p) for n, p in params.items()},
        "nu": {n: torch.zeros_like(p) for n, p in params.items()},
    }


@torch.no_grad()
def apply_gradients(params: dict, grads: dict, opt: dict, cfg: NerfCfg) -> None:
    """optax's chain, in place: clip_by_global_norm(gradient_max_norm)
    (g -> (g / norm) * max_norm when norm >= max_norm), Adam (b1 0.9,
    b2 0.999, eps 1e-15, bias-corrected), then -lr(count) with
    lr(count) = lrate * decay_rate ** (count / n_step)."""
    b1, b2, eps = 0.9, 0.999, 1e-15
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < cfg.gradient_max_norm
    count = opt["count"] + 1
    c1 = 1.0 - b1**count
    c2 = 1.0 - b2**count
    lr = cfg.lrate * cfg.decay_rate ** (opt["count"] / cfg.n_step)
    for name, p in params.items():
        g = torch.where(keep, grads[name], (grads[name] / norm) * cfg.gradient_max_norm)
        mu = opt["mu"][name].mul_(b1).add_((1 - b1) * g)
        nu = opt["nu"][name].mul_(b2).add_((1 - b2) * (g * g))
        p.add_((mu / c1) / (torch.sqrt(nu / c2) + eps), alpha=-lr)
    opt["count"] = count


class NerfModel(nn.Module):
    """The trained parameters: hash table, MLP, per-frame features and
    per-frame pose corrections (the JAX package's params tree)."""

    def __init__(self, grid: torch.Tensor, mlp: nn.Module, features: torch.Tensor, pose: torch.Tensor):
        super().__init__()
        self.grid = nn.Parameter(grid)
        self.mlp = mlp
        self.features = nn.Parameter(features)
        self.pose = nn.Parameter(pose)


class NerfRunner:
    """Train a neural SDF object field from posed RGB-D views and extract
    its mesh."""

    def __init__(self, cfg: NerfCfg, rgbs, depths, masks, poses, K, build_pcd, seed: int = 0,
                 device="cuda"):
        """rgbs (N, H, W, 3) float [0, 1] preprocessed, depths (N, H, W)
        normalized, poses (N, 4, 4) cam_in_ob normalized CV, build_pcd
        (M, 3) normalized object points for the occupancy grid. The
        initial parameters come from a CPU generator seeded with `seed`."""
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch_config.default_device(device)
        dev = self.device
        self.K = np.asarray(K, np.float64)
        self.H, self.W = depths.shape[1:3]
        self.n_frames = len(rgbs)
        self.poses = np.asarray(poses, np.float64)

        occ_vox = cfg.occ_voxel_size * cfg.sc_factor
        self.occ = torch.as_tensor(
            build_occupancy_grid(np.asarray(build_pcd), occ_vox, cfg.occ_dilate), device=dev
        )
        rays = [
            make_frame_rays(
                rgbs[i],
                depths[i],
                masks[i] if masks is not None else (depths[i] != BAD_DEPTH * cfg.sc_factor),
                self.K,
                i,
                # frame 0's mask is assumed perfect: its dilated ring's
                # BAD_DEPTH rays supervise free space (nerf_runner.py:276-286)
                dilate=cfg.first_frame_dilate if i == 0 else cfg.dilate_mask_size,
            )
            for i in range(self.n_frames)
        ]
        rays_np = {k: np.concatenate([r[k] for r in rays]) for k in rays[0]}
        self._denoise_dropped = 0
        if cfg.denoise_depth_use_octree_cloud:
            rays_np = self._denoise_rays_octree_cloud(rays_np, build_pcd)
        rays_np["frame_id"] = rays_np["frame_id"].astype(np.int64)
        self.rays = {k: torch.as_tensor(v, device=dev) for k, v in rays_np.items()}
        self.n_rays = int(self.rays["dir"].shape[0])
        logger.info("rays: %d over %d frames", self.n_rays, self.n_frames)

        self.grid_cfg = HashGridCfg(
            n_levels=cfg.num_levels,
            level_dim=cfg.feature_grid_dim,
            base_resolution=cfg.base_res,
            desired_resolution=cfg.finest_res,
            log2_hashmap_size=cfg.log2_hashmap_size,
            layout=cfg.grid_layout,
        )
        gen = torch.Generator().manual_seed(seed)
        self.model = NerfModel(
            init_hashgrid(self.grid_cfg, gen),
            init_nerf_mlp(self.grid_cfg.out_dim, cfg.multires_views**2 + cfg.frame_features, gen),
            torch.randn((self.n_frames, cfg.frame_features), generator=gen),
            torch.zeros((self.n_frames, 6)),
        ).to(dev)
        self.c2w = torch.as_tensor(self.poses.astype(np.float32), device=dev)
        self.opt = init_opt_state(dict(self.model.named_parameters()))
        self.global_step = 0
        self._gen = torch.Generator(device=dev)

    def load_params(self, state_dict: dict, opt: dict | None = None) -> None:
        """Set the parameters (and, with `opt` = {"count", "mu", "nu"},
        the optimizer state), e.g. from models.convert.nerf_params_from_jax."""
        self.model.load_state_dict(state_dict)
        if opt is not None:
            self.opt = {
                "count": int(opt["count"]),
                **{
                    m: {n: opt[m][n].to(p.device, p.dtype).clone() for n, p in self.model.named_parameters()}
                    for m in ("mu", "nu")
                },
            }

    def _denoise_rays_octree_cloud(self, rays_np, build_pcd):
        """Drop rays whose depth point lies more than 2 cm (real scale) from
        the fused build cloud (nerf_runner.py:179-196, host cKDTree)."""
        from scipy.spatial import cKDTree

        cfg = self.cfg
        depth = rays_np["depth"]
        sel = depth <= cfg.far * cfg.sc_factor  # BAD_DEPTH rays excluded
        if not sel.any() or len(np.asarray(build_pcd)) == 0:
            return rays_np
        pts_cam = rays_np["dir"][sel] * depth[sel, None]
        tf = self.poses[rays_np["frame_id"][sel]]
        pts_w = np.einsum("nij,nj->ni", tf[:, :3, :3], pts_cam) + tf[:, :3, 3]
        dists, _ = cKDTree(np.asarray(build_pcd)).query(pts_w, k=1, workers=-1)
        bad = dists > 0.02 * cfg.sc_factor
        keep = np.ones(len(depth), bool)
        keep[np.nonzero(sel)[0][bad]] = False
        self._denoise_dropped = int(bad.sum())
        logger.info("octree-cloud denoise: dropped %d rays", self._denoise_dropped)
        return {k: v[keep] for k, v in rays_np.items()}

    # ----------------------------------------------------------- render

    def _frame_tf(self, frame_ids):
        """Per-frame corrected cam_in_ob (nerf_runner.py:769-771)."""
        cfg = self.cfg
        if cfg.optimize_poses:
            corr = pose_array_matrices(self.model.pose, cfg.max_trans * cfg.sc_factor, cfg.max_rot)
            return corr[frame_ids] @ self.c2w[frame_ids]
        return self.c2w[frame_ids]

    def truncation(self, step=None) -> float:
        """The truncation band at train step `step` in normalized units
        (nerf_runner.py:491-504; trunc_decay_type '' = constant), rounded
        as the JAX package's f32 arithmetic on its f32 step; step None is
        the constant band."""
        cfg = self.cfg
        f32 = np.float32
        if step is None or cfg.trunc_decay_type == "":
            tr = f32(cfg.trunc)
        elif cfg.trunc_decay_type == "linear":
            tr = f32(cfg.trunc_start) - f32(cfg.trunc_start - cfg.trunc) * (f32(step) / f32(cfg.n_step))
        elif cfg.trunc_decay_type == "exp":
            lamb = f32(np.log(cfg.trunc / cfg.trunc_start) / (cfg.n_step / 4))
            tr = np.maximum(f32(cfg.trunc_start) * np.exp(f32(step) * lamb), f32(cfg.trunc))
        else:
            raise ValueError(f"trunc_decay_type {cfg.trunc_decay_type!r}: '', 'linear' or 'exp'")
        return float(f32(f32(tr) * f32(cfg.sc_factor)))

    def draw(self, n: int, generator: torch.Generator):
        """The jitter of one render of n rays, in the JAX package's key
        order: occupancy (n, candidate_mult * n_samples), around-depth
        (n, n_samples_around_depth), importance (n, n_importance) or None
        when off, near-band ties (n, n_samples) or None when off."""
        cfg = self.cfg
        dev = self.device

        def rand(cols, on=True):
            return torch.rand((n, cols), generator=generator, device=dev) if on else None

        return (
            rand(cfg.candidate_mult * cfg.n_samples),
            rand(cfg.n_samples_around_depth),
            rand(cfg.n_importance, cfg.n_importance > 0),
            rand(cfg.n_samples, self._subsets()),
        )

    def _subsets(self) -> bool:
        return self.cfg.occ_keep_frac is not None and self.cfg.occ_keep_frac < 1.0

    def render_rays(self, batch, u_occ, u_depth=None, trunc=None, u_imp=None, u_tie=None, perturb=True):
        """batch: dir (N, 3), depth (N,), frame_id (N,) on the device; the
        draws of `draw` (u_depth, u_imp unused at perturb=False, which
        takes the band's midpoints and a linspace). Returns dict: rgb
        (N, 3), raw_rgb, sdf (N, S), z_vals, valid, weights, and, with
        eikonal_weight > 0 and grad mode on, the SDF's gradient at the
        samples, normals (N, S, 3), differentiable again."""
        cfg = self.cfg
        dirs, depth, frame_ids = batch["dir"], batch["depth"], batch["frame_id"]
        N = dirs.shape[0]
        tf = self._frame_tf(frame_ids)
        rays_o_w = tf[:, :3, 3]
        rays_d_w = (tf[:, :3, :3] @ dirs[:, :, None])[..., 0]
        far_clip = cfg.far * cfg.sc_factor
        if trunc is None:
            trunc = cfg.trunc * cfg.sc_factor

        z_all, valid_all = sample_occupied(
            self.occ, rays_o_w, rays_d_w, cfg.n_samples, u=u_occ, depth=depth, trunc=trunc,
            far_clip=far_clip, candidate_mult=cfg.candidate_mult,
        )
        if self._subsets():
            # drop the occupancy samples farthest from the depth band
            keep = max(1, int(round(cfg.n_samples * cfg.occ_keep_frac)))
            z_all, valid_all = subset_near_band(
                z_all, valid_all, depth, trunc, cfg.neg_trunc_ratio, keep, u_tie,
                near=cfg.near * cfg.sc_factor, far=far_clip,
            )
        if cfg.n_samples_around_depth > 0:
            S2 = cfg.n_samples_around_depth
            has_d = (depth >= cfg.near * cfg.sc_factor) & (depth <= far_clip)
            lo = depth - trunc
            hi = depth + trunc * cfg.neg_trunc_ratio
            jitter = u_depth if perturb else 0.5
            u = (torch.arange(S2, dtype=torch.float32, device=dirs.device)[None] + jitter) / S2
            z_d = lo[:, None] + (hi - lo)[:, None] * u
            z_all = torch.cat([z_all, z_d], dim=-1)
            valid_all = torch.cat([valid_all, has_d[:, None].expand(N, S2)], dim=-1)

        feats = self.model.features[frame_ids]
        view_w = rays_d_w / torch.linalg.norm(rays_d_w, dim=-1, keepdim=True)
        view1 = torch.cat([sh_encode(view_w, cfg.multires_views), feats], dim=-1)
        dtype = torch.bfloat16 if cfg.amp else torch.float32

        def points(z_vals):
            return rays_o_w[:, None] + rays_d_w[:, None] * z_vals[..., None]

        def run_network(pts_w, valid, table_grad=True):
            S = pts_w.shape[1]
            valid = valid & torch.all(torch.abs(pts_w) <= 1.0, dim=-1)
            if profiling.recording():
                profiling.count("nerf.points", N * S)
            profiling.mark("nerf.encode")
            emb = hashgrid_encode(self.model.grid, pts_w.reshape(-1, 3), self.grid_cfg,
                                  table_grad=table_grad).reshape(N, S, -1)
            profiling.mark("nerf.mlp")
            raw = self.model.mlp(emb, view1[:, None].expand(N, S, view1.shape[-1]), dtype)
            return raw, valid

        def band_weights(z_vals, valid):
            # sdf2weights band rendering (nerf_runner.py:848-885)
            sdf_from_depth = (depth[:, None] - z_vals) / trunc
            w = torch.sigmoid(sdf_from_depth * cfg.sdf_lambda) * torch.sigmoid(-sdf_from_depth * cfg.sdf_lambda)
            band = (z_vals - depth[:, None] <= trunc * cfg.neg_trunc_ratio) & (z_vals - depth[:, None] >= -trunc)
            depth_ok = depth[:, None] <= far_clip
            w = torch.where(band & depth_ok & valid, w, 0.0)
            return w / (torch.sum(w, dim=-1, keepdim=True) + 1e-10)

        raw, valid_all = run_network(points(z_all), valid_all)
        w = band_weights(z_all, valid_all)

        if cfg.n_importance > 0:
            # Hierarchical resampling (nerf_runner.py:806-829, one shared
            # model): draw from the first pass's weight pdf over the
            # midpoints of the samples as they stand (occupancy then
            # around-depth, not sorted), evaluate, merge z-sorted.
            z_mid = 0.5 * (z_all[:, 1:] + z_all[:, :-1])
            z_imp = sample_pdf(z_mid, w[:, 1:-1], cfg.n_importance, u_imp if perturb else None).detach()
            valid_imp = torch.any(valid_all, dim=-1, keepdim=True).expand(z_imp.shape)
            raw_imp, valid_imp = run_network(points(z_imp), valid_imp)
            z_all, order = torch.sort(torch.cat([z_all, z_imp], dim=-1), dim=-1, stable=True)
            raw = torch.gather(torch.cat([raw, raw_imp], dim=1), 1, order[..., None].expand(-1, -1, raw.shape[-1]))
            valid_all = torch.gather(torch.cat([valid_all, valid_imp], dim=-1), 1, order)
            w = band_weights(z_all, valid_all)

        rgb_logits = raw[..., :3]
        out = {
            "rgb": torch.sum(w[..., None] * torch.sigmoid(rgb_logits), dim=-2),
            "raw_rgb": rgb_logits,
            "sdf": raw[..., 3],
            "z_vals": z_all,
            "valid": valid_all,
            "weights": w,
        }
        if cfg.eikonal_weight > 0 and torch.is_grad_enabled():
            # |grad sdf| at every sample (nerf_runner.py:563-567): a second
            # pass whose points' gradient, differentiable again, carries
            # the eikonal loss. Its own table gradient is skipped: the MLP
            # is piecewise linear in its input, so that term is zero.
            pw = points(z_all)
            if not pw.requires_grad:
                pw = pw.detach().requires_grad_()
            sdf_sum = run_network(pw, valid_all, table_grad=False)[0][..., 3].sum()
            out["normals"] = torch.autograd.grad(sdf_sum, pw, create_graph=True)[0]
        return out

    # ------------------------------------------------------------ losses

    def loss(self, batch, u_occ, u_depth, u_imp=None, u_tie=None, step=None):
        """-> (loss, aux dict of the loss terms under the JAX names),
        differentiable in the model's parameters; `step` anneals the
        truncation band (None: constant)."""
        cfg = self.cfg
        trunc = self.truncation(step)
        out = self.render_rays(batch, u_occ, u_depth, trunc=trunc, u_imp=u_imp, u_tie=u_tie)
        sdf, z_vals, valid = out["sdf"], out["z_vals"], out["valid"]
        target_d = batch["depth"][:, None]
        far_clip = cfg.far * cfg.sc_factor

        valid_rays = torch.any(valid, dim=-1)
        ray_w = torch.where(batch["frame_id"] == 0, cfg.first_frame_weight, 1.0) * valid_rays
        sample_w = ray_w[:, None] * valid

        rgb_loss = cfg.rgb_weight * torch.mean((out["rgb"] - batch["rgb"]) ** 2 * ray_w[:, None])

        # masks (nerf_helpers.py:398-428)
        valid_depth = (target_d >= cfg.near * cfg.sc_factor) & (target_d <= far_clip)
        front = z_vals < target_d - trunc
        back = z_vals > target_d + trunc * cfg.neg_trunc_ratio
        sdf_mask = (~front) & (~back) & valid_depth

        fs_mask = (target_d > far_clip) & (sdf < cfg.fs_sdf)
        fs_loss = torch.mean(((sdf - cfg.fs_sdf) * fs_mask) ** 2 * sample_w) * 0.5 * cfg.fs_weight
        empty_mask = front & (target_d <= far_clip) & (sdf < 1)
        empty_loss = torch.mean(torch.abs(sdf - 1) * empty_mask * sample_w) * cfg.empty_weight
        sdf_loss = (
            torch.mean(((z_vals + sdf * trunc) * sdf_mask - target_d * sdf_mask) ** 2 * sample_w)
            * 0.5
            * cfg.trunc_weight
        )
        loss = rgb_loss + fs_loss + empty_loss + sdf_loss
        aux = {"rgb_loss": rgb_loss, "fs_loss": fs_loss, "empty_loss": empty_loss, "sdf_loss": sdf_loss}

        if cfg.depth_weight > 0:
            # depth MSE at the first SDF sign change (nerf_runner.py:540-547)
            crossing = (sdf[:, 1:] * sdf[:, :-1]) < 0
            inds = torch.argmax(crossing.to(torch.int32), dim=1)  # the first crossing
            z_min = torch.gather(z_vals, 1, inds[:, None])
            dw = ray_w[:, None] * (target_d <= far_clip) * torch.any(crossing, dim=-1, keepdim=True)
            aux["depth_loss"] = torch.mean((z_min * dw - target_d * dw) ** 2) * cfg.depth_weight
            loss = loss + aux["depth_loss"]
        if cfg.fs_rgb_weight > 0:
            # white in front of the surface (nerf_runner.py:558-561)
            aux["fs_rgb_loss"] = torch.mean(
                ((torch.sigmoid(out["raw_rgb"]) - 1.0) * front[..., None]) ** 2 * sample_w[..., None]
            ) * cfg.fs_rgb_weight
            loss = loss + aux["fs_rgb_loss"]
        if cfg.eikonal_weight > 0:
            # |grad sdf| = 1 inside the narrow band (nerf_runner.py:563-567).
            # vector_norm's gradient at a zero normal is 0 (jnp.linalg.norm's
            # is NaN there: ROADMAP queue 3).
            nrm = torch.linalg.vector_norm(out["normals"], dim=-1)
            m = (sdf < 1.0) & valid
            eik = torch.sum(((nrm - 1.0) ** 2) * m) / (torch.sum(m) + 1e-9)
            aux["eikonal_loss"] = eik * cfg.eikonal_weight
            loss = loss + aux["eikonal_loss"]

        if cfg.frame_features > 0:
            loss = loss + cfg.feature_reg_weight * torch.mean(self.model.features**2)
        if cfg.optimize_poses and cfg.pose_reg_weight > 0:
            loss = loss + cfg.pose_reg_weight * torch.linalg.norm(self.model.pose[1:])
        return loss, aux

    # ------------------------------------------------------------ train

    def loss_and_grads(self, batch_idx=None, u_occ=None, u_depth=None, u_imp=None, u_tie=None, *,
                       generator=None, step=None):
        """One batch through the loss and autograd at train step `step`
        (default: the runner's global_step). Draws not given come from
        `generator` (on the runner's device). Returns (loss, aux, grads by
        parameter name)."""
        profiling.mark("nerf.sample")
        if batch_idx is None:
            batch_idx = self._batch_rows(generator)
        batch = {k: v[batch_idx] for k, v in self.rays.items()}
        given = (u_occ, u_depth, u_imp, u_tie)
        if any(d is None for d in given):
            drawn = self.draw(len(batch_idx), generator)
            u_occ, u_depth, u_imp, u_tie = (g if g is not None else d for g, d in zip(given, drawn))
        self.model.zero_grad(set_to_none=True)
        loss, aux = self.loss(batch, u_occ, u_depth, u_imp, u_tie,
                              step=self.global_step if step is None else step)
        profiling.mark("nerf.backward")
        loss.backward()
        grads = {
            n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in self.model.named_parameters()
        }
        self.model.zero_grad(set_to_none=True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def apply_gradients(self, grads) -> None:
        """One optimizer update of the model's parameters, in place."""
        apply_gradients(dict(self.model.named_parameters()), grads, self.opt, self.cfg)

    def _batch_rows(self, generator):
        return torch.randint(0, self.n_rays, (self.cfg.n_rand,), generator=generator, device=self.device)

    def step_draws(self, seed: int, step: int):
        """The draws that `step(seed)` takes at global step `step`, drawn
        again: (batch_idx, u_occ, u_depth, u_imp, u_tie) as
        `loss_and_grads` takes them."""
        gen = torch.Generator(device=self.device).manual_seed(_step_seed(seed, step))
        idx = self._batch_rows(gen)
        return (idx, *self.draw(len(idx), gen))

    def train_step(self, generator=None, batch_idx=None, u_occ=None, u_depth=None, u_imp=None, u_tie=None):
        """One optimizer step at global_step; returns (loss, aux) as device
        tensors. A request of kind "nerf" while the recorder records."""
        with profiling.request("nerf"), profiling.span("nerf.step"), profiling.stages(self.device):
            loss, aux, grads = self.loss_and_grads(batch_idx, u_occ, u_depth, u_imp, u_tie, generator=generator)
            profiling.mark("nerf.adam")
            self.apply_gradients(grads)
        self.global_step += 1
        return loss, aux

    def step(self, seed: int = 0):
        """One step of `train` seeded with `seed`: the device generator
        seeded from (seed, global_step), then `train_step`. Returns (loss,
        aux) as device tensors."""
        self._gen.manual_seed(_step_seed(seed, self.global_step))
        return self.train_step(self._gen)

    def train(self, seed: int = 0, ckpt_dir=None, i_weights: int = 500, artifact_dir=None,
              i_img: int = 500, i_mesh: int = 500, i_pose: int = 500, metric_sink=None):
        """Steps from global_step to n_step inclusive, step `it` drawing
        from a device generator seeded with (seed, it), so a resumed run
        continues an interrupted one exactly. Every tenth of the run it
        reads the losses (one host sync), logs them and hands
        {"loss", *aux} to `metric_sink(step, scalars)` (the reference's
        log_scalar hook, nerf_runner.py:648-650). With `ckpt_dir` it saves
        the train state every `i_weights` steps and at the end
        (`save_weights`; `resume` reads it), with `artifact_dir` it dumps
        images, meshes and poses at the i_img / i_mesh / i_pose cadence
        (nerf_runner.py:593-680)."""
        n = self.cfg.n_step + 1
        for it in range(self.global_step, n):
            loss, aux = self.step(seed)
            if it % max(1, n // 10) == 0:
                names = ["loss", *aux]
                vals = torch.stack([loss, *aux.values()]).tolist()
                scalars = dict(zip(names, vals))
                logger.info(
                    "step %d/%d loss=%.4f rgb=%.4f sdf=%.4f fs=%.4f empty=%.4f",
                    it, n, scalars["loss"], scalars["rgb_loss"], scalars["sdf_loss"],
                    scalars["fs_loss"], scalars["empty_loss"],
                )
                if metric_sink is not None:
                    metric_sink(it, scalars)
            if ckpt_dir is not None and it > 0 and it % i_weights == 0:
                self.save_weights(ckpt_dir)
            if artifact_dir is not None and it > 0:
                self._dump_artifacts(artifact_dir, it, i_img, i_mesh, i_pose)
        if ckpt_dir is not None:
            self.save_weights(ckpt_dir)

    def _dump_artifacts(self, artifact_dir: str, it: int, i_img: int, i_mesh: int, i_pose: int = 0):
        """Eval imagery, mesh and pose snapshots (nerf_runner.py:596-680):
        pose/step_*.npy (real-world cam_in_ob), image/step_*.png (frame 0's
        render beside its depth) and mesh/step_*.obj (when not empty)."""
        from ..utils.vis import write_png

        if i_pose > 0 and it % i_pose == 0:
            os.makedirs(f"{artifact_dir}/pose", exist_ok=True)
            np.save(f"{artifact_dir}/pose/step_{it:07d}.npy", self.get_optimized_poses_in_real_world())
        if i_img > 0 and it % i_img == 0:
            os.makedirs(f"{artifact_dir}/image", exist_ok=True)
            rgb, depth = self.render_frame(0)
            canvas = np.concatenate([rgb, np.repeat(depth[..., None] / max(depth.max(), 1e-6), 3, -1)], axis=1)
            write_png(f"{artifact_dir}/image/step_{it:07d}.png", (np.clip(canvas, 0, 1) * 255).astype(np.uint8))
        if i_mesh > 0 and it % i_mesh == 0:
            mesh = self.extract_mesh(voxel_size=self.cfg.mesh_resolution)
            if len(mesh.vertices):
                os.makedirs(f"{artifact_dir}/mesh", exist_ok=True)
                self.mesh_to_real_world(mesh).export(f"{artifact_dir}/mesh/step_{it:07d}.obj")

    def save_weights(self, ckpt_dir: str) -> None:
        """The train state (parameters and optimizer) as
        ckpt_dir/step_{global_step:07d}/state.pt."""
        save_train_state(ckpt_dir, self.global_step, {"params": self.model.state_dict(), "opt": self.opt})

    def resume(self, ckpt_dir: str, step: int | None = None) -> None:
        """Restore the parameters and optimizer state saved at `step` (None:
        the latest) and continue from that step."""
        step, state = load_train_state(ckpt_dir, step, map_location=self.device)
        self.load_params(state["params"], state["opt"])
        self.global_step = step
        logger.info("resumed from step %d", step)

    @torch.no_grad()
    def render_frame(self, frame_idx: int, chunk: int = 4096, draws=None):
        """Render a training view from the field (nerf_runner.py:432-489) at
        perturb=False. The occupancy (and near-band tie) jitter comes from
        `draws` = (u_occ, u_tie) for the frame's rays in order, else from a
        generator seeded with 0 (the JAX package uses PRNGKey(0)). Returns (rgb (H, W, 3), depth (H, W) normalized:
        the first SDF sign change along the sorted samples, far where
        there is none), zeros outside the frame's rays."""
        cfg = self.cfg
        sel = torch.nonzero(self.rays["frame_id"] == frame_idx)[:, 0]
        n = len(sel)
        if draws is None:
            u_occ, _, _, u_tie = self.draw(n, torch.Generator(device=self.device).manual_seed(0))
        else:
            u_occ, u_tie = draws
        rgb_out, depth_out = [], []
        for s0 in range(0, n, chunk):
            idx = sel[s0 : s0 + chunk]
            batch = {k: self.rays[k][idx] for k in ("dir", "depth", "frame_id")}
            out = self.render_rays(batch, u_occ[s0 : s0 + chunk],
                                   u_tie=None if u_tie is None else u_tie[s0 : s0 + chunk], perturb=False)
            z_s, order = torch.sort(out["z_vals"], dim=-1, stable=True)
            sdf_s = torch.gather(out["sdf"], 1, order)
            crossing = (sdf_s[:, 1:] * sdf_s[:, :-1]) < 0
            first = torch.argmax(crossing.to(torch.int32), dim=-1)
            zhit = torch.gather(z_s, 1, first[:, None])[:, 0]
            rgb_out.append(out["rgb"])
            depth_out.append(torch.where(torch.any(crossing, dim=-1), zhit, cfg.far * cfg.sc_factor))
        dirs = self.rays["dir"][sel].cpu().numpy()
        rgb_n = torch.cat(rgb_out).cpu().numpy() if n else np.zeros((0, 3), np.float32)
        depth_n = torch.cat(depth_out).cpu().numpy() if n else np.zeros((0,), np.float32)
        rgb_full = np.zeros((self.H, self.W, 3), np.float32)
        depth_full = np.zeros((self.H, self.W), np.float32)
        u = np.round(dirs[:, 0] * self.K[0, 0] / dirs[:, 2] + self.K[0, 2]).astype(int)
        v = np.round(dirs[:, 1] * self.K[1, 1] / dirs[:, 2] + self.K[1, 2]).astype(int)
        ok = (u >= 0) & (u < self.W) & (v >= 0) & (v < self.H)
        rgb_full[v[ok], u[ok]] = rgb_n[ok]
        depth_full[v[ok], u[ok]] = depth_n[ok]
        return rgb_full, depth_full

    # ------------------------------------------------------ extraction

    @torch.no_grad()
    def query_sdf_grid(self, voxel_size: float | None = None, chunk: int = 262144):
        """Dense f32 SDF grid over [-1, 1]^3, 1 outside the occupancy grid."""
        cfg = self.cfg
        vs = (voxel_size or cfg.mesh_resolution) * cfg.sc_factor
        coords = np.arange(-1 + 0.5 * vs, 1.0, vs)
        G = len(coords)
        xx, yy, zz = np.meshgrid(coords, coords, coords, indexing="ij")
        pts = torch.as_tensor(
            np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32), device=self.device
        )
        idxs = torch.nonzero(occupancy_lookup(self.occ, pts))[:, 0]
        sdf = torch.ones(len(pts), dtype=torch.float32, device=self.device)
        for s in range(0, len(idxs), chunk):
            sel = idxs[s : s + chunk]
            emb = hashgrid_encode(self.model.grid, pts[sel], self.grid_cfg)
            sdf[sel] = self.model.mlp.sdf(emb)
        return sdf.reshape(G, G, G).cpu().numpy(), coords

    def extract_mesh(self, voxel_size: float | None = None, isolevel: float = 0.0) -> TriMesh:
        """Marching tetrahedra on the SDF grid (nerf_runner.py:1062-1118)."""
        sdf, coords = self.query_sdf_grid(voxel_size)
        vs = coords[1] - coords[0]
        verts, faces = marching_tetrahedra(sdf, iso=isolevel, spacing=(vs, vs, vs), origin=(coords[0],) * 3)
        return TriMesh(vertices=verts, faces=faces)

    def mesh_to_real_world(self, mesh: TriMesh) -> TriMesh:
        """Un-normalize and apply the optimized first-frame offset
        (nerf_helpers.py:215-250, CV convention)."""
        mesh = mesh.copy()
        mesh.vertices = mesh.vertices / self.cfg.sc_factor - np.asarray(self.cfg.translation).reshape(1, 3)
        offset = self.get_pose_offset()
        mesh.vertices = mesh.vertices @ offset[:3, :3].T + offset[:3, 3]
        return mesh

    def get_optimized_poses_in_real_world(self) -> np.ndarray:
        """Corrected cam_in_ob poses in meters (nerf_helpers.py:224-250)."""
        cfg = self.cfg
        with torch.no_grad():
            corr = pose_array_matrices(self.model.pose, cfg.max_trans * cfg.sc_factor, cfg.max_rot)
        out = corr.cpu().numpy() @ self.poses
        out[:, :3, 3] /= cfg.sc_factor
        out[:, :3, 3] -= np.asarray(cfg.translation)
        return out

    def get_pose_offset(self) -> np.ndarray:
        """Offset aligning the optimized first frame back to its original
        pose, applied to the mesh (nerf_helpers.py:244-249)."""
        original = self.poses.copy()
        original[:, :3, 3] /= self.cfg.sc_factor
        original[:, :3, 3] -= np.asarray(self.cfg.translation)
        optimized = self.get_optimized_poses_in_real_world()
        return np.linalg.inv(optimized[0]) @ original[0]
