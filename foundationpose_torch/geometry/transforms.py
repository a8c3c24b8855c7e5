"""Homogeneous transforms and the refiner's egocentric delta-pose algebra.

Port of foundationpose_tpu/geometry/transforms.py on torch tensors.
"""
from __future__ import annotations

import torch


def transform_pts(pts: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) (or (..., 3, 3) for 2D) transforms to (..., N, D)
    points; a batch dim of tf that differs from the point dim broadcasts
    each transform over every point."""
    if tf.ndim >= 3 and tf.shape[-3] != pts.shape[-2]:
        tf = tf[..., None, :, :]
    return (tf[..., :-1, :-1] @ pts[..., None] + tf[..., :-1, -1:])[..., 0]


def normalize_rotation(pose: torch.Tensor) -> torch.Tensor:
    """Remove per-column scale from the rotation block."""
    scales = torch.linalg.norm(pose[..., :3, :3], dim=-2, keepdim=True)
    out = pose.clone()
    out[..., :3, :3] = pose[..., :3, :3] / scales
    return out


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    out = torch.eye(4, dtype=R.dtype, device=R.device).expand(*batch, 4, 4).clone()
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    return out


def invert_pose(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    Rt = pose[..., :3, :3].transpose(-1, -2)
    return make_pose(Rt, -(Rt @ pose[..., :3, 3:4])[..., 0])


def egocentric_delta_pose_to_pose(
    A_in_cam: torch.Tensor, trans_delta: torch.Tensor, rot_mat_delta: torch.Tensor
) -> torch.Tensor:
    """Apply an egocentric delta: t += dt, R = dR @ R."""
    return make_pose(
        rot_mat_delta @ A_in_cam[..., :3, :3],
        A_in_cam[..., :3, 3] + trans_delta,
    )
