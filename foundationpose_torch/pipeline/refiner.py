"""Iterative pose refinement: render -> crop -> RefineNet -> pose update.

Port of foundationpose_tpu/pipeline/refiner.py (the reference's
PoseRefinePredictor.predict, predict_pose_refine.py:149-295). The JAX
`lax.scan` over iterations is a Python loop; the whole hypothesis batch
is one tensor.
"""
from __future__ import annotations

import torch

from .. import torch_config  # noqa: F401
from ..geometry.projection import invert_affine2d, project_points
from ..geometry.rotations import rotation_6d_to_matrix, so3_exp_map
from ..geometry.transforms import egocentric_delta_pose_to_pose
from ..utils import profiling
from .config import RefinerCfg, torch_dtype
from .crops import make_crop_inputs
from .mesh_tensors import MeshTensors


def apply_pose_delta(
    poses: torch.Tensor,
    trans: torch.Tensor,
    rot: torch.Tensor,
    cfg: RefinerCfg,
    mesh_diameter,
    K: torch.Tensor | None = None,
    tf_to_crops: torch.Tensor | None = None,
) -> torch.Tensor:
    """Network outputs -> updated poses (predict_pose_refine.py:195-231)."""
    if cfg.trans_rep == "tracknet":
        if cfg.normalize_xyz:
            diam = torch.as_tensor(mesh_diameter, dtype=torch.float32, device=poses.device)
            trans_delta = trans * (diam / 2.0)
        else:
            # filled on the device (no host copy: a captured step holds it)
            tn = torch.stack([torch.full((), float(v), dtype=torch.float32, device=poses.device)
                              for v in cfg.trans_normalizer])
            trans_delta = torch.tanh(trans) * tn
    elif cfg.trans_rep == "deepim":
        # uv shift in crop pixels + relative z scale
        t_a = poses[..., :3, 3]
        z_pred = trans[:, 2] * t_a[:, 2]
        uv_a = project_points(t_a, K)
        uv_a_crop = (tf_to_crops[:, :2, :2] @ uv_a[..., None])[..., 0] + tf_to_crops[:, :2, 2]
        uv_pred_crop = uv_a_crop + trans[:, :2] * cfg.input_res
        inv_tf = invert_affine2d(tf_to_crops)
        uv_pred = (inv_tf[:, :2, :2] @ uv_pred_crop[..., None])[..., 0] + inv_tf[:, :2, 2]
        x = (uv_pred[:, 0] - K[0, 2]) / K[0, 0] * z_pred
        y = (uv_pred[:, 1] - K[1, 2]) / K[1, 1] * z_pred
        trans_delta = torch.stack([x, y, z_pred], dim=-1) - t_a
    else:
        raise NotImplementedError(f"trans_rep={cfg.trans_rep}")

    if cfg.rot_rep == "axis_angle":
        rot_mat_delta = so3_exp_map(torch.tanh(rot) * cfg.rot_normalizer).transpose(-1, -2)
    elif cfg.rot_rep == "6d":
        rot_mat_delta = rotation_6d_to_matrix(rot).transpose(-1, -2)
    else:
        raise NotImplementedError(f"rot_rep={cfg.rot_rep}")
    return egocentric_delta_pose_to_pose(poses, trans_delta, rot_mat_delta)


@torch.inference_mode()
def refine_poses(
    net,
    cfg: RefinerCfg,
    mesh: MeshTensors,
    poses: torch.Tensor,  # (N, 4, 4)
    K: torch.Tensor,
    rgb: torch.Tensor,  # (H, W, 3) [0, 1]
    xyz_map: torch.Tensor,  # (H, W, 3)
    mesh_diameter,
    iterations: int = 5,
    return_history: bool = False,
):
    """Refine all hypotheses `iterations` times with the RefineNet `net`;
    returns (N, 4, 4), plus the pre-step poses of every iteration
    stacked (iterations, N, 4, 4) with return_history."""
    dtype = torch_dtype(cfg.compute_dtype)
    cur = poses.to(torch.float32)
    hist = []
    for _ in range(int(iterations)):
        profiling.mark("crops")
        a, b, tf = make_crop_inputs(
            mesh, cur, K, rgb, xyz_map, mesh_diameter,
            input_res=cfg.input_res,
            crop_ratio=cfg.crop_ratio,
            normalize_xyz=cfg.normalize_xyz,
            invalid_z=cfg.xyz_invalid_z,
            use_normal=cfg.use_normal,
            raster=cfg.raster,
        )
        profiling.mark("refiner")
        out = net(a, b, dtype=dtype)
        if return_history:
            hist.append(cur)
        profiling.mark("update")
        cur = apply_pose_delta(
            cur, out["trans"], out["rot"], cfg, mesh_diameter, K=K, tf_to_crops=tf
        )
    if return_history:
        empty = cur.new_zeros((0, *cur.shape))
        return cur, (torch.stack(hist) if hist else empty)
    return cur
