"""Model-free subsystem: neural SDF object field reconstruction.

Port of foundationpose_tpu/nerf (reference bundlesdf/run_nerf.py): from
~16 posed RGB-D reference views, train a small SDF field, extract a
mesh, bake its texture and return it in meters; the mesh then feeds the
same FoundationPose estimator.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ..meshio import TriMesh

from .. import torch_config  # noqa: F401
from .config import LINEMOD_OVERRIDES, TPU_FAST_OVERRIDES, NerfCfg  # noqa: F401
from .runner import NerfRunner, check_supported
from .scene import compute_scene_bounds, preprocess_data
from .texture import bake_texture

logger = logging.getLogger(__name__)


def run_neural_object_field(
    cfg: NerfCfg,
    K: np.ndarray,
    rgbs: np.ndarray,
    depths: np.ndarray,
    masks: np.ndarray,
    cam_in_obs: np.ndarray,
    tex_res: int | None = None,
    seed: int = 0,
    artifact_dir: str | None = None,
    device="cuda",
) -> tuple[TriMesh, NerfRunner]:
    """Full model-free pipeline (run_nerf.py:18-46, CV convention): scene
    normalization -> SDF field training -> mesh extraction -> texture
    bake -> un-normalize to meters. Trains and renders on `device`."""
    check_supported(cfg)
    rgbs = np.asarray(rgbs)
    depths = np.asarray(depths).astype(np.float32)
    masks = np.asarray(masks)
    cam_in_obs = np.asarray(cam_in_obs).astype(np.float64)

    sc_factor, translation, pts_norm = compute_scene_bounds(
        K, rgbs, depths, masks, cam_in_obs, eps=cfg.dbscan_eps, min_samples=cfg.dbscan_min_samples,
    )
    logger.info("scene bounds: sc=%.3f translation=%s", sc_factor, translation)
    cfg = dataclasses.replace(cfg, sc_factor=sc_factor, translation=tuple(np.asarray(translation).tolist()))

    rgbs_n, depths_n, poses_n = preprocess_data(rgbs, depths, masks, cam_in_obs, sc_factor, translation)
    runner = NerfRunner(cfg, rgbs_n, depths_n, masks, poses_n, K, build_pcd=pts_norm, seed=seed,
                        device=device)
    runner.train(seed=seed, artifact_dir=artifact_dir)

    mesh = runner.extract_mesh(voxel_size=cfg.mesh_resolution)
    if len(mesh.vertices) == 0 or len(mesh.faces) == 0:
        raise RuntimeError(
            "neural object field produced an empty mesh — "
            "field not converged (increase n_step) or bad input poses/masks"
        )
    textured = bake_texture(
        runner.mesh_to_real_world(mesh),
        rgbs,
        depths,
        runner.get_optimized_poses_in_real_world(),
        K,
        tex_res=tex_res or cfg.tex_res,
        top_views=cfg.tex_top_views,
        device=runner.device,
    )
    return textured, runner
