"""Scene-bounds normalization for the neural object field (host numpy).

Port of foundationpose_tpu/nerf/scene.py (reference bundlesdf/tool.py:
17-130): fuse the masked depth clouds in the object frame, keep the
biggest DBSCAN cluster, normalize to [-1, 1] * 0.9, all in the OpenCV
camera convention.

sklearn's DBSCAN is replaced by scipy (`dbscan_labels`): core points
have at least min_samples points within eps, themselves included; the
clusters are the connected components of the core points' eps-graph,
labelled in order of their lowest core index, as sklearn discovers them;
a border point (not core, a core point within eps) takes the first
discovered of its neighbouring clusters, as sklearn's expansion leaves
it; every other point is noise (-1). At min_samples=1 every point is a
core point.
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
    """sklearn.cluster.DBSCAN(eps, min_samples).fit(pts).labels_ for (N, 3)
    points: cluster ids from 0 in order of discovery, -1 for noise."""
    n = len(pts)
    pairs = cKDTree(pts).query_pairs(eps, output_type="ndarray")
    a, b = pairs[:, 0], pairs[:, 1]
    core = np.bincount(pairs.ravel(), minlength=n) + 1 >= min_samples
    both = core[a] & core[b]
    graph = coo_matrix((np.ones(int(both.sum()), np.int8), (a[both], b[both])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    # rank the core components by their lowest point index
    first = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(first, comp[core], np.nonzero(core)[0])
    rank = np.full_like(first, -1)
    found = first < n
    rank[np.nonzero(found)[0][np.argsort(first[found], kind="stable")]] = np.arange(int(found.sum()))
    labels = np.where(core, rank[comp], -1)
    # border points take the earliest-discovered cluster among their core neighbours
    border = np.full(n, np.iinfo(np.int64).max)
    for src, dst in ((a, b), (b, a)):
        sel = core[src] & ~core[dst]
        np.minimum.at(border, dst[sel], labels[src[sel]])
    is_border = ~core & (border < np.iinfo(np.int64).max)
    labels[is_border] = border[is_border]
    return labels


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
