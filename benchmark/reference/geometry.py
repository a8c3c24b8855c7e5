"""Plain geometry of the reference: meshes, views, the hypothesis grid and
rotations, in numpy (float64) and plain torch.

Written from the published description (FoundationPose, arXiv:2312.08344;
NVlabs/FoundationPose Utils.py:483-507, estimater.py:44-124): an icosphere
of camera views looking at the object, in-plane turns of each, greedy
first-fit deduplication under the object's symmetries, and the
pytorch3d axis-angle maps. Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch


def icosphere(subdivisions: int, radius: float = 1.0):
    """Subdivided icosahedron on the sphere: vertices (V, 3), faces (F, 3)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                      [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                     dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                      [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                      [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                      [8, 6, 7], [9, 8, 1]], dtype=np.int64)
    for _ in range(subdivisions):
        edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                        axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        mid_idx = len(verts) + np.arange(len(uniq))
        n = len(faces)
        m01, m12, m20 = mid_idx[inv[:n]], mid_idx[inv[n:2 * n]], mid_idx[inv[2 * n:]]
        faces = np.concatenate([np.stack([faces[:, 0], m01, m20], 1),
                                np.stack([faces[:, 1], m12, m01], 1),
                                np.stack([faces[:, 2], m20, m12], 1),
                                np.stack([m01, m12, m20], 1)])
        verts = np.concatenate([verts, (verts[uniq[:, 0]] + verts[uniq[:, 1]]) / 2.0])
        verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    return verts * radius, faces


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (trimesh's default)."""
    v = np.asarray(vertices, np.float64)
    fn = np.cross(v[faces[:, 1]] - v[faces[:, 0]], v[faces[:, 2]] - v[faces[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norms = np.linalg.norm(vn, axis=-1, keepdims=True)
    norms[norms < 1e-12] = 1.0
    return vn / norms


def diameter(vertices: np.ndarray) -> float:
    """Largest distance between two vertices (attained on the hull)."""
    from scipy.spatial import ConvexHull

    pts = np.asarray(vertices, np.float64)
    pts = pts[ConvexHull(pts).vertices]
    return float(np.linalg.norm(pts[None] - pts[:, None], axis=-1).max())


def camera_views(n_views: int) -> np.ndarray:
    """Camera-in-object poses (N, 4, 4) at the vertices of the coarsest
    icosphere with at least n_views vertices, z toward the origin,
    x = up x z (up = +z; +x where degenerate)."""
    sub = 1
    while len(icosphere(sub)[0]) < n_views:
        sub += 1
    verts = icosphere(sub)[0]
    out = np.tile(np.eye(4), (len(verts), 1, 1))
    z = -verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    x = np.cross(np.array([0.0, 0.0, 1.0])[None], z)
    x[(x == 0).all(axis=-1)] = [1.0, 0.0, 0.0]
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    out[:, :3, 0], out[:, :3, 1], out[:, :3, 2], out[:, :3, 3] = x, y, z, verts
    return out


def rotation_grid(n_views: int, inplane_deg: float, cluster_deg: float, pad_to: int):
    """Object-in-camera rotations of the register's hypotheses: each view's
    inverse after each in-plane turn, deduplicated greedily (a pose is
    dropped when a kept one lies within cluster_deg; no symmetries), then
    padded with identities to a multiple of pad_to. -> ((N, 4, 4) float64,
    (N,) bool valid)."""
    poses = []
    for cam in camera_views(n_views):
        for a in np.deg2rad(np.arange(0, 360, inplane_deg)):
            rz = np.eye(4)
            rz[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            poses.append(np.linalg.inv(cam @ rz))
    poses = np.asarray(poses)
    thres = np.deg2rad(cluster_deg)
    kept = [0]
    for i in range(1, len(poses)):
        R = poses[kept, :3, :3] @ poses[i, :3, :3].T
        cos = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
        if not (np.arccos(cos) < thres).any():
            kept.append(i)
    grid = poses[kept]
    pad = (-len(grid)) % pad_to
    valid = np.concatenate([np.ones(len(grid), bool), np.zeros(pad, bool)])
    return np.concatenate([grid, np.tile(np.eye(4), (pad, 1, 1))]), valid


def hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation (..., 3, 3), Rodrigues."""
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3)."""
    cos = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0, -1.0, 1.0)
    th = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-4
    s = torch.where(small, torch.ones_like(th), torch.sin(th))
    return w * torch.where(small, 0.5 + th * th / 12.0, th / (2.0 * s))[..., None]


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((*R.shape[:-2], 4, 4), dtype=R.dtype, device=R.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def pose_gap(a: torch.Tensor, b: torch.Tensor):
    """Translation gap (m) and rotation gap (deg) between (..., 4, 4) poses,
    in float64; the angle from the chord ||Ra - Rb|| = 2 sqrt(2) sin(angle / 2),
    which keeps its digits where arccos of the trace loses them."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    dt = torch.linalg.norm(a[..., :3, 3] - b[..., :3, 3], dim=-1)
    chord = torch.linalg.norm((a[..., :3, :3] - b[..., :3, :3]).flatten(-2), dim=-1)
    return dt, torch.rad2deg(2.0 * torch.arcsin(torch.clamp(chord / (2.0 * 2.0 ** 0.5), max=1.0)))


def add_gap(a: torch.Tensor, b: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """ADD between (..., 4, 4) poses: the mean distance between the points
    pts (V, 3) placed by each, in float64 (m)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    d = (a[..., None, :3, :3] - b[..., None, :3, :3]) @ pts.to(torch.float64)[:, :, None]
    d = d[..., 0] + (a[..., None, :3, 3] - b[..., None, :3, 3])
    return torch.linalg.norm(d, dim=-1).mean(-1)
