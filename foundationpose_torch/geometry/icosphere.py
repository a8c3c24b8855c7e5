"""Icosphere viewpoint sampling (host-side numpy, one-shot at object reset).

A copy of foundationpose_tpu/geometry/icosphere.py: importing that module
runs its package's __init__, which imports JAX, and this package never
does. Runs once per object on the host.
"""
from __future__ import annotations

import numpy as np


def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron vertices (12, 3) and faces (20, 3)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def subdivide(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split every triangle into 4 via edge midpoints (shared, deduped)."""
    edges = np.sort(
        np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1
    )
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mid = (verts[uniq[:, 0]] + verts[uniq[:, 1]]) / 2.0
    mid_idx = len(verts) + np.arange(len(uniq))
    m01 = mid_idx[inv[: len(faces)]]
    m12 = mid_idx[inv[len(faces) : 2 * len(faces)]]
    m20 = mid_idx[inv[2 * len(faces) :]]
    new_faces = np.concatenate(
        [
            np.stack([faces[:, 0], m01, m20], axis=1),
            np.stack([faces[:, 1], m12, m01], axis=1),
            np.stack([faces[:, 2], m20, m12], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ]
    )
    return np.concatenate([verts, mid]), new_faces


def icosphere(subdivisions: int = 1, radius: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron projected to the sphere.

    Vertex counts per subdivision level: 12, 42, 162, 642, ... matching
    trimesh.creation.icosphere counts (Utils.py:483-492 picks the lowest
    level with >= n_views vertices).
    """
    verts, faces = icosahedron()
    for _ in range(subdivisions):
        verts, faces = subdivide(verts, faces)
        verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    return verts * radius, faces


def sample_views_icosphere(n_views: int, radius: float = 1.0) -> np.ndarray:
    """Camera-in-object poses on an icosphere looking at the origin.

    Semantics of Utils.py:483-507: position at each vertex, z-axis toward
    the origin, x = cross(up=[0,0,1], z) with [1,0,0] fallback when
    degenerate, y = cross(z, x). Returns (N, 4, 4) cam_in_ob.
    """
    subdivision = 1
    while True:
        verts, _ = icosphere(subdivision, radius)
        if len(verts) >= n_views:
            break
        subdivision += 1

    n = len(verts)
    cam_in_obs = np.tile(np.eye(4)[None], (n, 1, 1))
    cam_in_obs[:, :3, 3] = verts
    up = np.array([0.0, 0.0, 1.0])
    z_axis = -verts
    z_axis = z_axis / np.linalg.norm(z_axis, axis=-1, keepdims=True)
    x_axis = np.cross(up[None], z_axis)
    invalid = (x_axis == 0).all(axis=-1)
    x_axis[invalid] = np.array([1.0, 0.0, 0.0])
    x_axis = x_axis / np.linalg.norm(x_axis, axis=-1, keepdims=True)
    y_axis = np.cross(z_axis, x_axis)
    y_axis = y_axis / np.linalg.norm(y_axis, axis=-1, keepdims=True)
    cam_in_obs[:, :3, 0] = x_axis
    cam_in_obs[:, :3, 1] = y_axis
    cam_in_obs[:, :3, 2] = z_axis
    return cam_in_obs
