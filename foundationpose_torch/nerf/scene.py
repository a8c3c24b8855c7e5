"""Scene-bounds normalization for the neural object field (host numpy).

Port of foundationpose_tpu/nerf/scene.py (reference bundlesdf/tool.py:
17-130): fuse the masked depth clouds in the object frame, keep the
biggest DBSCAN cluster, normalize to [-1, 1] * 0.9, all in the OpenCV
camera convention.

sklearn's DBSCAN is replaced by scipy. With min_samples=1 every point is
a core point, so DBSCAN's clusters are exactly the connected components
of the graph linking points within eps of each other; they are labelled
in order of their lowest point index, as sklearn labels them, so the
largest cluster wins ties the same way.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from ..meshio import voxel_downsample

BAD_DEPTH = 99.0
BAD_COLOR = 0


def _depth_to_xyz(depth, K):
    H, W = depth.shape
    u, v = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    z = depth
    x = (u - K[0, 2]) * z / K[0, 0]
    y = (v - K[1, 2]) * z / K[1, 1]
    return np.stack([x, y, z], axis=-1)


def dbscan_labels(pts: np.ndarray, eps: float, min_samples: int = 1) -> np.ndarray:
    """DBSCAN cluster labels of (N, 3) points for min_samples=1."""
    if min_samples != 1:
        raise NotImplementedError(
            "DBSCAN with min_samples > 1 is not ported (ROADMAP queue 1, model-free item)"
        )
    n = len(pts)
    pairs = cKDTree(pts).query_pairs(eps, output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs), np.int8), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    # relabel by the lowest point index of each component
    first = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    rank = np.empty_like(first)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[comp]


def compute_scene_bounds(K, rgbs, depths, masks, cam_in_obs, eps=0.01, min_samples=1):
    """-> (sc_factor, translation (3,), normalized build cloud (N, 3))."""
    pts_all = []
    for i in range(len(rgbs)):
        xyz = _depth_to_xyz(depths[i], K)
        valid = (depths[i] >= 0.1) & (masks[i] > 0)
        pts = xyz[valid]
        if len(pts) == 0:
            continue
        pts, _ = voxel_downsample(pts, 0.01)
        pts = pts @ cam_in_obs[i][:3, :3].T + cam_in_obs[i][:3, 3]  # into the object frame
        pts_all.append(pts)
    pts = np.concatenate(pts_all)
    pts, _ = voxel_downsample(pts, eps / 5)

    labels = dbscan_labels(pts, eps, min_samples)
    ids, cnts = np.unique(labels, return_counts=True)
    pts = pts[labels == ids[np.argmax(cnts)]]

    max_xyz = pts.max(axis=0)
    min_xyz = pts.min(axis=0)
    center = (max_xyz + min_xyz) / 2
    sc_factor = 2.0 / (max_xyz - min_xyz).max() * 0.9
    translation = -center
    pts_norm = (pts + translation) * sc_factor
    return float(sc_factor), translation, pts_norm


def preprocess_data(rgbs, depths, masks, poses, sc_factor, translation):
    """Normalize frames and poses (nerf_helpers.py:252-274, CV convention).

    poses: cam_in_ob (N, 4, 4). Depths scaled to normalized units; pixels
    outside the mask get BAD_DEPTH / BAD_COLOR."""
    rgbs = np.asarray(rgbs).copy()
    depths = np.asarray(depths).astype(np.float32).copy()
    poses = np.asarray(poses).astype(np.float64).copy()
    depths[depths < 0.001] = BAD_DEPTH
    if masks is not None:
        rgbs[masks == 0] = BAD_COLOR
        depths[masks == 0] = BAD_DEPTH
    rgbs = (rgbs / 255.0).astype(np.float32)
    depths = depths * sc_factor
    poses[:, :3, 3] = (poses[:, :3, 3] + translation) * sc_factor
    return rgbs, depths, poses
