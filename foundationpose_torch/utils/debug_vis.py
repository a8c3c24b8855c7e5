"""Debug artifacts of a register, written when FoundationPose(debug >= 2).

Port of foundationpose_tpu/utils/debug_vis.py (the reference's canvases,
predict_pose_refine.py:241-293, predict_score.py:27-52): per hypothesis
one row [rgb A | depth A | rgb B | depth B], rows stacked by score rank.
Images go through `utils.vis.write_png` (imageio, else cv2).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .vis import depth_to_vis, make_grid_image, write_png


def crop_canvas(a: np.ndarray, b: np.ndarray, scores=None, max_rows: int = 16):
    """a, b: (N, H, W, 6) crop inputs (rgb + centered xyz). Returns one
    uint8 canvas image."""
    n = min(len(a), max_rows)
    rows = []
    for i in range(n):
        rgb_a = (np.clip(a[i, ..., :3], 0, 1) * 255).astype(np.uint8)
        rgb_b = (np.clip(b[i, ..., :3], 0, 1) * 255).astype(np.uint8)
        za = a[i, ..., 5]
        zb = b[i, ..., 5]
        zmin = min(za.min(), zb.min())
        zmax = max(za.max(), zb.max(), zmin + 1e-6)
        da = depth_to_vis(za - zmin + 1e-3, zmin=0, zmax=zmax - zmin, inverse=False)
        db = depth_to_vis(zb - zmin + 1e-3, zmin=0, zmax=zmax - zmin, inverse=False)
        rows.append(make_grid_image([rgb_a, da, rgb_b, db], nrow=4, padding=2))
    return make_grid_image(rows, nrow=1, padding=4)


def _frame(est, K, rgb, depth):
    from ..geometry.projection import depth_to_xyz_map

    dev = est.device
    K_t = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    rgb_t = torch.as_tensor(np.asarray(rgb), device=dev).to(torch.float32) / 255.0
    xyz = depth_to_xyz_map(torch.as_tensor(np.asarray(depth, np.float32), device=dev), K_t)
    return K_t, rgb_t, xyz


def _canvas(est, cfg, poses, K_t, rgb_t, xyz):
    from ..pipeline.crops import make_crop_inputs

    a, b, _ = make_crop_inputs(
        est.mesh_tensors, poses, K_t, rgb_t, xyz, est._diam,
        input_res=cfg.input_res, crop_ratio=cfg.crop_ratio,
        normalize_xyz=cfg.normalize_xyz, invalid_z=cfg.xyz_invalid_z, raster=cfg.raster,
    )
    return crop_canvas(a.cpu().numpy(), b.cpu().numpy())


@torch.inference_mode()
def dump_register_debug(est, debug_dir: str, K, rgb, depth) -> None:
    """vis_score.png: scorer-style crop canvases of the top 16 hypotheses
    of the last register() call, best first."""
    os.makedirs(debug_dir, exist_ok=True)
    canvas = _canvas(est, est.cfg.scorer, est.poses[:16], *_frame(est, K, rgb, depth))
    write_png(os.path.join(debug_dir, "vis_score.png"), canvas)


@torch.inference_mode()
def dump_refiner_debug(est, debug_dir: str, K, rgb, depth, iterations) -> None:
    """vis_refiner_iter{i}.png: the winning hypothesis before each refiner
    iteration (predict_pose_refine.py:241-293). The register keeps no
    intermediates, so the winner's path is replayed from its initial
    hypothesis (its rotation-grid row at the translation guess) with
    refine_poses(return_history=True): one hypothesis, the same steps."""
    from ..pipeline.refiner import refine_poses

    if est._guess_center is None or not est.has_refiner:
        return
    os.makedirs(debug_dir, exist_ok=True)
    init = est.rot_grid[est.best_id].clone()
    init[:3, 3] = torch.as_tensor(est._guess_center, dtype=torch.float32, device=est.device)
    K_t, rgb_t, xyz = _frame(est, K, rgb, depth)
    cfg = est.cfg.refiner
    _, hist = refine_poses(est.refiner, cfg, est.mesh_tensors, init[None], K_t, rgb_t, xyz,
                           est._diam, iterations=iterations, return_history=True)
    for i in range(hist.shape[0]):
        write_png(os.path.join(debug_dir, f"vis_refiner_iter{i}.png"),
                  _canvas(est, cfg, hist[i], K_t, rgb_t, xyz))


def dump_transformed_mesh(est, debug_dir: str, pose: np.ndarray) -> None:
    """debug >= 3: model_tf.obj, the object mesh under the estimated pose
    (run_demo.py:54-61 of the reference). The returned pose maps the
    original model frame, so the centering is undone first."""
    os.makedirs(debug_dir, exist_ok=True)
    mesh = est.mesh.copy()
    v = mesh.vertices + np.asarray(est.model_center).reshape(1, 3)
    mesh.vertices = (v @ pose[:3, :3].T + pose[:3, 3]).astype(mesh.vertices.dtype)
    mesh.export(os.path.join(debug_dir, "model_tf.obj"))
