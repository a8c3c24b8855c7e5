"""Camera projection, depth->XYZ maps and crop-window transforms.

Port of foundationpose_tpu/geometry/projection.py. Pixel convention:
integer pixel (row i, col j) has continuous coordinates (u, v) = (j, i).
"""
from __future__ import annotations

import numpy as np
import torch


def project_points(pts_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pinhole-project camera-space points (..., 3) -> pixels (..., 2)."""
    z = pts_cam[..., 2:3]
    z_safe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = pts_cam[..., 0:1] * K[0, 0] / z_safe + K[0, 2]
    v = pts_cam[..., 1:2] * K[1, 1] / z_safe + K[1, 2]
    return torch.cat([u, v], dim=-1)


def depth_to_xyz_map(
    depth: torch.Tensor, K: torch.Tensor, zfar: float = float("inf")
) -> torch.Tensor:
    """Per-pixel camera-space XYZ (..., H, W) -> (..., H, W, 3); invalid
    pixels (z < 0.001 or z > zfar) become zeros. K is (3, 3), or (..., 3,
    3) with one matrix per leading index of depth."""
    H, W = depth.shape[-2], depth.shape[-1]
    us = torch.arange(W, dtype=depth.dtype, device=depth.device)
    vs = torch.arange(H, dtype=depth.dtype, device=depth.device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")

    def k(i, j):
        return K[..., i, j, None, None]

    xs = (uu - k(0, 2)) * depth / k(0, 0)
    ys = (vv - k(1, 2)) * depth / k(1, 1)
    xyz = torch.stack([xs, ys, depth], dim=-1)
    invalid = (depth < 0.001) | (depth > zfar)
    return torch.where(invalid[..., None], torch.zeros_like(xyz), xyz)


def compute_crop_window_tf(
    poses: torch.Tensor,
    K: torch.Tensor,
    crop_ratio: float,
    out_size: int,
    mesh_diameter,
    round_box: bool = True,
) -> torch.Tensor:
    """Per-pose (N, 3, 3) affine from full-image pixels to the
    out_size x out_size crop ('box_3d' method): the object center and
    four in-plane offsets at radius diameter*crop_ratio/2 are projected
    and the largest pixel extent is the square half-width."""
    radius = torch.as_tensor(mesh_diameter, dtype=poses.dtype, device=poses.device)
    radius = radius * crop_ratio / 2.0
    zero = torch.zeros_like(radius)
    offsets = torch.stack(
        [
            torch.stack([zero, zero, zero]),
            torch.stack([radius, zero, zero]),
            torch.stack([-radius, zero, zero]),
            torch.stack([zero, radius, zero]),
            torch.stack([zero, -radius, zero]),
        ]
    )  # (5, 3)
    pts = poses[:, None, :3, 3] + offsets[None]
    uvs = project_points(pts, K)  # (N, 5, 2)
    center = uvs[:, 0]
    r = torch.amax(
        torch.abs(uvs - center[:, None]).reshape(poses.shape[0], -1), dim=-1
    )
    left = center[:, 0] - r
    right = center[:, 0] + r
    top = center[:, 1] - r
    bottom = center[:, 1] + r
    if round_box:
        # torch.round and jnp.round both round half to even
        left, right = torch.round(left), torch.round(right)
        top, bottom = torch.round(top), torch.round(bottom)
    sx = out_size / (right - left)
    sy = out_size / (bottom - top)
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    return torch.stack(
        [
            torch.stack([sx, z, -left * sx], -1),
            torch.stack([z, sy, -top * sy], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )


def invert_affine2d(tf: torch.Tensor) -> torch.Tensor:
    """Invert (..., 3, 3) axis-aligned affine crop transforms."""
    sx = tf[..., 0, 0]
    sy = tf[..., 1, 1]
    tx = tf[..., 0, 2]
    ty = tf[..., 1, 2]
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    return torch.stack(
        [
            torch.stack([1.0 / sx, z, -tx / sx], -1),
            torch.stack([z, 1.0 / sy, -ty / sy], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )


def guess_translation(depth: np.ndarray, mask: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Host-side initial translation: mask-bbox center ray x masked
    median depth (the degenerate-mask branch of register)."""
    vs, us = np.where(mask > 0)
    if len(us) == 0:
        return np.zeros(3, dtype=np.float64)
    uc = (us.min() + us.max()) / 2.0
    vc = (vs.min() + vs.max()) / 2.0
    valid = (mask.astype(bool)) & (depth >= 0.001)
    if not valid.any():
        return np.zeros(3, dtype=np.float64)
    zc = np.median(depth[valid])
    center = (np.linalg.inv(K) @ np.array([uc, vc, 1.0]).reshape(3, 1)) * zc
    return center.reshape(3)
