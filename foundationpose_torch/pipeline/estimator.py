"""FoundationPose public estimator API (register / track_one) on torch.

Port of foundationpose_tpu/pipeline/estimator.py, unpacked full-frame
path (the JAX estimator with register_pack = register_roi = track_pack =
track_roi = False):

    est = FoundationPose(mesh=mesh, refiner_params=..., scorer_params=...,
                         device="cuda")
    pose = est.register(K, rgb, depth, ob_mask, iteration=5)  # (4, 4) np
    pose = est.track_one(rgb, depth, K, iteration=2)          # (4, 4) np

Per-frame compute runs on `device` (pipeline/graph.py); the rotation
grid is built once per object on the host (icosphere + greedy symmetry
clustering), as in the reference (estimater.py:106-124).
"""
from __future__ import annotations

import dataclasses
import logging
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

from ..torch_config import default_device
from ..geometry.clustering import cluster_poses
from ..geometry.icosphere import sample_views_icosphere
from ..geometry.projection import guess_translation
from ..models.convert import load_npz_params, params_from_jax
from ..models.networks import (
    RefineNet,
    ScoreNetMultiPair,
    init_refine_net,
    init_score_net,
)
from .config import EstimatorCfg
from .graph import register_body, track_body
from .mesh_tensors import make_mesh_tensors
from foundationpose_tpu.meshio import TriMesh, compute_mesh_diameter, voxel_downsample

logger = logging.getLogger(__name__)


def _rotation_about_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    out = np.eye(4)
    out[:2, :2] = [[c, -s], [s, c]]
    return out


def prepare_render_mesh(mesh: TriMesh, cfg: EstimatorCfg, diameter: float) -> TriMesh:
    """Bake textures to vertex colors and/or decimate dense meshes per
    cfg. `mesh` is the centered mesh."""
    render_src = mesh
    if cfg.vertex_color_render and mesh.has_texture:
        from foundationpose_tpu.meshio import texture_to_vertex_colors

        render_src = texture_to_vertex_colors(mesh)
    if cfg.max_render_faces is not None and len(mesh.faces) > cfg.max_render_faces:
        from foundationpose_tpu.meshio import decimate_vertex_clustering

        vox = diameter / 160.0  # crop-pixel scale
        render_src = decimate_vertex_clustering(mesh, vox)
        while len(render_src.faces) > cfg.max_render_faces:
            vox *= 1.4
            render_src = decimate_vertex_clustering(mesh, vox)
        logger.info(
            "render mesh decimated: %d -> %d faces", len(mesh.faces), len(render_src.faces)
        )
    return render_src


def _as_module(params, cls, net_cfg):
    """A net module from a module or a state_dict."""
    if isinstance(params, nn.Module):
        return params
    if isinstance(params, Mapping):
        net = cls(net_cfg)
        net.load_state_dict(params)
        return net.eval()
    raise TypeError(f"expected an nn.Module or a state_dict, got {type(params)}")


def _cfg_from_meta(d: dict, base):
    """RefinerCfg/ScorerCfg from the JSON `pipeline_cfg` the JAX package
    embeds in checkpoints; unknown fields are ignored, lists -> tuples."""
    d = dict(d)
    net_d = d.pop("net", None)
    raster_d = d.pop("raster", None)

    def coerce(cfg, upd):
        known = {f.name for f in dataclasses.fields(cfg)}
        upd = {k: tuple(v) if isinstance(v, list) else v for k, v in upd.items() if k in known}
        return dataclasses.replace(cfg, **upd)

    out = coerce(base, d)
    if net_d is not None:
        out = dataclasses.replace(out, net=coerce(base.net, net_d))
    if raster_d is not None:
        out = dataclasses.replace(out, raster=coerce(base.raster, raster_d))
    return out


class FoundationPose:
    def __init__(
        self,
        model_pts=None,
        model_normals=None,
        symmetry_tfs=None,
        mesh: TriMesh | None = None,
        cfg: EstimatorCfg | None = None,
        refiner_params=None,
        scorer_params=None,
        device: str | torch.device = "cuda",
    ):
        """`refiner_params` / `scorer_params`: a RefineNet /
        ScoreNetMultiPair module or its state_dict. `device` is where
        every frame is computed; asking for CUDA without a card raises."""
        self.device = default_device(device)
        self.cfg = cfg or EstimatorCfg()
        self.pose_last: torch.Tensor | None = None
        # Weights-awareness: a randomly initialized refiner would apply
        # garbage deltas, so refinement is skipped unless real weights
        # are supplied; "auto" scoring falls back to the depth scorer.
        self.has_refiner = refiner_params is not None
        if self.cfg.scorer.mode == "auto":
            resolved = "network" if scorer_params is not None else "depth"
            self.cfg = dataclasses.replace(
                self.cfg, scorer=dataclasses.replace(self.cfg.scorer, mode=resolved)
            )
            logger.info("scorer mode auto -> %s", resolved)
        if refiner_params is None:
            refiner = init_refine_net(self.cfg.refiner.net, torch.Generator().manual_seed(0))
            logger.info("no refiner weights: refinement iterations disabled")
        else:
            refiner = _as_module(refiner_params, RefineNet, self.cfg.refiner.net)
        if scorer_params is None:
            scorer = init_score_net(self.cfg.scorer.net, torch.Generator().manual_seed(1))
        else:
            scorer = _as_module(scorer_params, ScoreNetMultiPair, self.cfg.scorer.net)
        self.refiner = refiner.to(self.device).eval()
        self.scorer = scorer.to(self.device).eval()

        self.reset_object(
            model_pts=model_pts, model_normals=model_normals,
            symmetry_tfs=symmetry_tfs, mesh=mesh,
        )
        self.make_rotation_grid(
            min_n_views=self.cfg.min_n_views, inplane_step=self.cfg.inplane_step_deg
        )

    # ------------------------------------------------------------ setup

    def reset_object(self, model_pts=None, model_normals=None, symmetry_tfs=None, mesh=None):
        """Re-center the mesh, compute diameter and points, upload the
        render mesh (estimater.py:44-78)."""
        if mesh is None:
            raise ValueError("mesh is required")
        max_xyz = mesh.vertices.max(axis=0)
        min_xyz = mesh.vertices.min(axis=0)
        self.model_center = (min_xyz + max_xyz) / 2
        self.mesh_ori = mesh
        mesh = mesh.copy()
        mesh.vertices = mesh.vertices - self.model_center.reshape(1, 3)

        self.diameter = compute_mesh_diameter(mesh.vertices)
        self.vox_size = max(self.diameter / 20.0, 0.003)
        pts, normals = voxel_downsample(mesh.vertices, self.vox_size, mesh.vertex_normals)
        self.max_xyz = pts.max(axis=0)
        self.min_xyz = pts.min(axis=0)
        self.pts = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
        self.normals = torch.as_tensor(normals, dtype=torch.float32, device=self.device)
        self.mesh = mesh
        render_src = prepare_render_mesh(mesh, self.cfg, self.diameter)
        self.mesh_tensors = make_mesh_tensors(render_src, self.cfg.max_tex_size, self.device)
        self._diam = torch.tensor(self.diameter, dtype=torch.float32, device=self.device)
        if symmetry_tfs is None:
            self.symmetry_tfs = np.eye(4)[None]
        else:
            self.symmetry_tfs = np.asarray(symmetry_tfs, dtype=np.float64)
        logger.info(
            "reset done: diameter=%.4f V=%d F=%d",
            self.diameter, len(mesh.vertices), len(mesh.faces),
        )

    def get_tf_to_centered_mesh(self) -> np.ndarray:
        tf = np.eye(4)
        tf[:3, 3] = -self.model_center
        return tf

    def make_rotation_grid(self, min_n_views=40, inplane_step=60):
        """Icosphere views x in-plane rotations, deduplicated under
        symmetry and padded to a multiple of cfg.rot_grid_pad."""
        cam_in_obs = sample_views_icosphere(n_views=min_n_views)
        rot_grid = []
        for cam_in_ob in cam_in_obs:
            for inplane_rot in np.deg2rad(np.arange(0, 360, inplane_step)):
                rot_grid.append(np.linalg.inv(cam_in_ob @ _rotation_about_z(inplane_rot)))
        rot_grid = cluster_poses(
            self.cfg.cluster_angle_deg, 99999.0, np.asarray(rot_grid), self.symmetry_tfs
        )
        n = len(rot_grid)
        pad = (-n) % self.cfg.rot_grid_pad
        if pad:
            rot_grid = np.concatenate([rot_grid, np.tile(np.eye(4)[None], (pad, 1, 1))])
        self.hyp_valid = torch.as_tensor(
            np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]), device=self.device
        )
        self.rot_grid = torch.as_tensor(rot_grid, dtype=torch.float32, device=self.device)
        logger.info("rotation grid: %d (+%d pad)", n, pad)

    def load_weights(self, refiner_path: str | None = None, scorer_path: str | None = None):
        """Load `.npz` param files written by the JAX package
        (FoundationPose.save_weights), with the pipeline config they
        embed."""
        for path, kind in ((refiner_path, "refiner"), (scorer_path, "scorer")):
            if not path:
                continue
            if not path.endswith(".npz"):
                raise ValueError(f"{path}: only .npz param files are supported")
            tree, meta = load_npz_params(path)
            base = getattr(self.cfg, kind)
            pc = (meta or {}).get("pipeline_cfg")
            if pc is not None:
                sub = _cfg_from_meta(pc, base)
            elif (meta or {}).get("reference_config") is not None:
                raise NotImplementedError(
                    f"{path}: converted reference checkpoints are not supported yet"
                )
            else:
                trunk = tree.get("encodeA") or tree.get("encoderA") or {}
                use_bn = "bn" in trunk.get("0", {})
                sub = dataclasses.replace(base, net=dataclasses.replace(base.net, use_bn=use_bn))
            if kind == "scorer":
                sub = dataclasses.replace(sub, mode="network")  # weights imply network
            cls = RefineNet if kind == "refiner" else ScoreNetMultiPair
            net = _as_module(params_from_jax(tree, sub.net), cls, sub.net)
            setattr(self, kind, net.to(self.device).eval())
            self.cfg = dataclasses.replace(self.cfg, **{kind: sub})
            if kind == "refiner":
                self.has_refiner = True

    # --------------------------------------------------------- inference

    def _frame(self, K, rgb, depth):
        dev = self.device
        K_t = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        rgb_t = torch.as_tensor(np.asarray(rgb, np.uint8), device=dev).to(torch.float32) / 255.0
        depth_t = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
        return K_t, rgb_t, depth_t

    @torch.inference_mode()
    def register(self, K, rgb, depth, ob_mask, ob_id=None, iteration=5) -> np.ndarray:
        """Single-frame pose estimation (estimater.py:159-240)."""
        mask_np = np.asarray(ob_mask)
        depth_np = np.asarray(depth)
        valid = (depth_np >= 0.001) & (mask_np > 0)
        if valid.sum() < 4:
            # Degenerate input: identity rotation at the translation guess
            # (raw-depth median, filtering skipped).
            logger.info("valid region too small; returning translation guess")
            pose = np.eye(4)
            pose[:3, 3] = guess_translation(depth_np, mask_np, np.asarray(K))
            return pose
        iters = int(iteration) if self.has_refiner else 0
        K_t, rgb_t, depth_t = self._frame(K, rgb, depth_np)
        mask_t = torch.as_tensor(mask_np, device=self.device)
        order, refined, scores, _center, _n = register_body(
            self.refiner, self.scorer, self.cfg, self.mesh_tensors, self.rot_grid,
            self.hyp_valid, K_t, rgb_t, depth_t, mask_t, self._diam, iters,
        )
        self.poses = refined
        self.scores = scores
        self.order = order
        self.pose_last = refined[0]
        self.best_id = int(order[0])
        raw = self.pose_last.cpu().numpy().astype(np.float64)
        return raw @ self.get_tf_to_centered_mesh()

    @torch.inference_mode()
    def track_one(self, rgb, depth, K, iteration=2) -> np.ndarray:
        """Per-frame tracking: refine-only from pose_last
        (estimater.py:250-268)."""
        if self.pose_last is None:
            raise RuntimeError("Please init pose by register() first")
        iters = int(iteration) if self.has_refiner else 0
        K_t, rgb_t, depth_t = self._frame(K, rgb, depth)
        pose = track_body(
            self.refiner, self.cfg, self.mesh_tensors, self.pose_last, K_t, rgb_t,
            depth_t, self._diam, iters,
        )
        self.pose_last = pose
        return pose.cpu().numpy().astype(np.float64) @ self.get_tf_to_centered_mesh()
