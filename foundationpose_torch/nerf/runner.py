"""Neural-object-field training and mesh extraction on torch tensors.

Port of foundationpose_tpu/nerf/runner.py (reference
bundlesdf/nerf_runner.py) on the default configuration's path: ray
records from posed RGB-D frames, occupancy-grid sampling, the hash-grid
encoder (ops/hashgrid.py, whose backward runs K3 or K4 on the card), the
NeRFSmall MLP, the SDF losses (nerf_runner.py:507-680), one train step
through autograd, and marching-tetrahedra extraction.

The optimizer is optax's chain written out: clip_by_global_norm, Adam
(b1 0.9, b2 0.999, eps 1e-15, bias-corrected) and the learning rate
lrate * decay_rate ** (count / n_step), count being the number of
updates already applied.

Random draws come from a `torch.Generator` on the runner's device; the
render and the train step also take the draws themselves (batch indices,
the occupancy jitter (N, candidate_mult * n_samples), the around-depth
jitter (N, n_samples_around_depth)) so that tests can pin them. On a CUDA
device the host runs only what the JAX package runs on the host: ray
building, the denoise, the sample grid of the extraction and marching
tetrahedra.

Options that ship off in NerfCfg and are not ported raise
NotImplementedError (ROADMAP queue 1, the model-free item).
"""
from __future__ import annotations

import logging

import numpy as np
import torch
from scipy import ndimage
from torch import nn

from ..meshio import TriMesh

from .. import torch_config
from ..ops.hashgrid import LAYOUTS, HashGridCfg, hashgrid_encode, init_hashgrid
from ..ops.marching import marching_tetrahedra
from .config import NerfCfg
from .model import init_nerf_mlp, pose_array_matrices, sh_encode
from .occupancy import build_occupancy_grid, occupancy_lookup, sample_occupied
from .scene import BAD_DEPTH

logger = logging.getLogger(__name__)

_QUEUED = "not ported (ROADMAP queue 1, model-free reconstruction: NeRF options)"


def check_supported(cfg: NerfCfg) -> None:
    """Raise NotImplementedError for the options the port does not carry."""
    off = {
        "n_importance > 0 (sample_pdf)": cfg.n_importance > 0,
        "eikonal_weight > 0": cfg.eikonal_weight > 0,
        "depth_weight > 0": cfg.depth_weight > 0,
        "fs_rgb_weight > 0": cfg.fs_rgb_weight > 0,
        "occ_keep_frac < 1 (subset_near_band)": cfg.occ_keep_frac is not None
        and cfg.occ_keep_frac < 1.0,
        f"trunc_decay_type {cfg.trunc_decay_type!r}": cfg.trunc_decay_type != "",
    }
    for name, on in off.items():
        if on:
            raise NotImplementedError(f"NerfCfg {name}: {_QUEUED}")
    if cfg.grid_layout not in LAYOUTS:
        raise NotImplementedError(f"NerfCfg grid_layout {cfg.grid_layout!r}: {_QUEUED}")


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

    def truncation(self) -> float:
        """The truncation band in normalized units, rounded as the JAX
        package's f32 product (trunc_decay_type '' = constant)."""
        return float(np.float32(np.float32(self.cfg.trunc) * np.float32(self.cfg.sc_factor)))

    def draw(self, n: int, generator: torch.Generator):
        """The jitter of one render of n rays: (occupancy (n, M),
        around-depth (n, S2)) uniforms."""
        cfg = self.cfg
        M = cfg.candidate_mult * cfg.n_samples
        u_occ = torch.rand((n, M), generator=generator, device=self.device)
        u_depth = torch.rand((n, cfg.n_samples_around_depth), generator=generator, device=self.device)
        return u_occ, u_depth

    def render_rays(self, batch, u_occ, u_depth, trunc=None):
        """batch: dir (N, 3), depth (N,), frame_id (N,) on the device.
        Returns dict: rgb (N, 3), raw_rgb, sdf (N, S), z_vals, valid,
        weights."""
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
        if cfg.n_samples_around_depth > 0:
            S2 = cfg.n_samples_around_depth
            has_d = (depth >= cfg.near * cfg.sc_factor) & (depth <= far_clip)
            lo = depth - trunc
            hi = depth + trunc * cfg.neg_trunc_ratio
            u = (torch.arange(S2, dtype=torch.float32, device=dirs.device)[None] + u_depth) / S2
            z_d = lo[:, None] + (hi - lo)[:, None] * u
            z_all = torch.cat([z_all, z_d], dim=-1)
            valid_all = torch.cat([valid_all, has_d[:, None].expand(N, S2)], dim=-1)

        feats = self.model.features[frame_ids]
        view_w = rays_d_w / torch.linalg.norm(rays_d_w, dim=-1, keepdim=True)
        view1 = torch.cat([sh_encode(view_w, cfg.multires_views), feats], dim=-1)
        dtype = torch.bfloat16 if cfg.amp else torch.float32

        S = z_all.shape[-1]
        pts_w = rays_o_w[:, None] + rays_d_w[:, None] * z_all[..., None]
        valid_all = valid_all & torch.all(torch.abs(pts_w) <= 1.0, dim=-1)
        emb = hashgrid_encode(self.model.grid, pts_w.reshape(-1, 3), self.grid_cfg).reshape(N, S, -1)
        raw = self.model.mlp(emb, view1[:, None].expand(N, S, view1.shape[-1]), dtype)

        # sdf2weights band rendering (nerf_runner.py:848-885)
        sdf_from_depth = (depth[:, None] - z_all) / trunc
        w = torch.sigmoid(sdf_from_depth * cfg.sdf_lambda) * torch.sigmoid(-sdf_from_depth * cfg.sdf_lambda)
        band = (z_all - depth[:, None] <= trunc * cfg.neg_trunc_ratio) & (z_all - depth[:, None] >= -trunc)
        depth_ok = depth[:, None] <= far_clip
        w = torch.where(band & depth_ok & valid_all, w, 0.0)
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-10)

        rgb_logits = raw[..., :3]
        return {
            "rgb": torch.sum(w[..., None] * torch.sigmoid(rgb_logits), dim=-2),
            "raw_rgb": rgb_logits,
            "sdf": raw[..., 3],
            "z_vals": z_all,
            "valid": valid_all,
            "weights": w,
        }

    # ------------------------------------------------------------ losses

    def loss(self, batch, u_occ, u_depth):
        """-> (loss, aux dict of the four loss terms), differentiable in
        the model's parameters."""
        cfg = self.cfg
        trunc = self.truncation()
        out = self.render_rays(batch, u_occ, u_depth, trunc=trunc)
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
        if cfg.frame_features > 0:
            loss = loss + cfg.feature_reg_weight * torch.mean(self.model.features**2)
        if cfg.optimize_poses and cfg.pose_reg_weight > 0:
            loss = loss + cfg.pose_reg_weight * torch.linalg.norm(self.model.pose[1:])
        return loss, aux

    # ------------------------------------------------------------ train

    def loss_and_grads(self, batch_idx=None, u_occ=None, u_depth=None, generator=None):
        """One batch through the loss and autograd. Draws not given come
        from `generator` (on the runner's device). Returns (loss, aux,
        grads by parameter name)."""
        if batch_idx is None:
            batch_idx = torch.randint(
                0, self.n_rays, (self.cfg.n_rand,), generator=generator, device=self.device
            )
        batch = {k: v[batch_idx] for k, v in self.rays.items()}
        if u_occ is None or u_depth is None:
            d_occ, d_depth = self.draw(len(batch_idx), generator)
            u_occ = d_occ if u_occ is None else u_occ
            u_depth = d_depth if u_depth is None else u_depth
        self.model.zero_grad(set_to_none=True)
        loss, aux = self.loss(batch, u_occ, u_depth)
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

    def train_step(self, generator=None, batch_idx=None, u_occ=None, u_depth=None):
        """One optimizer step; returns (loss, aux) as device tensors."""
        loss, aux, grads = self.loss_and_grads(batch_idx, u_occ, u_depth, generator)
        self.apply_gradients(grads)
        self.global_step += 1
        return loss, aux

    def train(self, seed: int = 0, ckpt_dir=None, artifact_dir=None):
        """n_step + 1 steps from the current step, draws from a generator
        on the device seeded with `seed`. Every tenth of the run it reads
        the losses and logs them (a host sync)."""
        if ckpt_dir is not None or artifact_dir is not None:
            raise NotImplementedError(f"NeRF checkpoints and artifact dumps: {_QUEUED}")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        n = self.cfg.n_step + 1
        for it in range(self.global_step, n):
            loss, aux = self.train_step(gen)
            if it % max(1, n // 10) == 0:
                logger.info(
                    "step %d/%d loss=%.4f rgb=%.4f sdf=%.4f fs=%.4f empty=%.4f",
                    it, n, float(loss), float(aux["rgb_loss"]), float(aux["sdf_loss"]),
                    float(aux["fs_loss"]), float(aux["empty_loss"]),
                )

    def render_frame(self, frame_idx: int, chunk: int = 4096):
        raise NotImplementedError(f"NerfRunner.render_frame: {_QUEUED}")

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
