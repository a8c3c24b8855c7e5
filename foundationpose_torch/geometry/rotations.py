"""Rotation parameterizations and maps on torch tensors.

Port of foundationpose_tpu/geometry/rotations.py: batched over leading
dimensions, f32, with the same small-angle branches.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp_map(log_rot: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) via Rodrigues
    (pytorch3d so3_exp_map semantics, p' = R p)."""
    theta2 = torch.sum(log_rot * log_rot, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(theta2_safe)
    sin_t_over_t = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    one_minus_cos_over_t2 = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / theta2_safe
    )
    K = hat(log_rot)
    KK = K @ K
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device).expand(K.shape)
    return (
        eye
        + sin_t_over_t[..., None, None] * K
        + one_minus_cos_over_t2[..., None, None] * KK
    )


def so3_log_map(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = theta < 1e-4
    sin_theta = torch.sin(theta)
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * safe_sin))
    return w * scale[..., None]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=_EPS)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation rep -> (..., 3, 3); Gram-Schmidt rows (pytorch3d)."""
    a1 = d6[..., 0:3]
    a2 = d6[..., 3:6]
    b1 = _unit(a1)
    b2 = _unit(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> first two rows flattened (..., 6)."""
    return torch.cat([R[..., 0, :], R[..., 1, :]], dim=-1)


def _rot(a, axis: int) -> torch.Tensor:
    """Rotation by angle `a` about coordinate axis 0, 1 or 2."""
    a = torch.as_tensor(a, dtype=torch.float32)
    c, s = torch.cos(a), torch.sin(a)
    i, j = [k for k in range(3) if k != axis]
    R = torch.eye(3, dtype=torch.float32)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    if axis == 1:  # y: the sine terms swap sign (right-handed)
        R[i, j], R[j, i] = s, -s
    return R


def euler_matrix(ax, ay, az) -> torch.Tensor:
    """Static-frame XYZ ('sxyz') euler angles -> 4x4: Rz @ Ry @ Rx."""
    R = _rot(az, 2) @ _rot(ay, 1) @ _rot(ax, 0)
    out = torch.eye(4, dtype=torch.float32)
    out[:3, :3] = R
    return out
