"""Greedy pose clustering under symmetry (object-reset time, one-shot).

A copy of foundationpose_tpu/geometry/clustering.py (that package's
__init__ imports JAX). Same native library, same numpy path.

Replaces the reference's C++ pybind module
(mycpp/src/app/pybind_api.cpp:24-68, mycpp/src/Utils.cpp:21-26).
A native C++ implementation (native/pose_cluster.cpp, loaded via ctypes)
is used when built; the numpy path is the always-available fallback and
the semantic reference for tests. Both are exact re-implementations of
the greedy first-fit rule:

  pose i is a duplicate iff some already-kept pose k satisfies
  ||t_i - t_k|| < dist_diff AND
  min_s geodesic(R_i @ R_s, R_k) < angle_diff.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_TRIED = False


def _load_native():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libfp_native.so",
    )
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            lib.cluster_poses.restype = ctypes.c_int
            lib.cluster_poses.argtypes = [
                ctypes.c_float,  # angle_diff_deg
                ctypes.c_float,  # dist_diff
                ctypes.POINTER(ctypes.c_float),  # poses (N,16)
                ctypes.c_int,  # N
                ctypes.POINTER(ctypes.c_float),  # symmetry tfs (S,16)
                ctypes.c_int,  # S
                ctypes.POINTER(ctypes.c_int),  # out kept indices (N)
            ]
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def _rotation_geodesic(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    """Geodesic angle between batches of rotations, radians."""
    m = R1 @ np.swapaxes(R2, -1, -2)
    tr = np.trace(m, axis1=-2, axis2=-1)
    c = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.arccos(c)


def cluster_poses_numpy(
    angle_diff_deg: float,
    dist_diff: float,
    poses: np.ndarray,
    symmetry_tfs: np.ndarray | None = None,
) -> np.ndarray:
    """Greedy first-fit dedup; returns the kept subset of poses (M, 4, 4)."""
    if symmetry_tfs is None:
        symmetry_tfs = np.eye(4)[None]
    poses = np.asarray(poses, dtype=np.float64)
    symmetry_tfs = np.asarray(symmetry_tfs, dtype=np.float64)
    radian_thres = angle_diff_deg / 180.0 * np.pi

    # Precompute each candidate's symmetry-orbit rotations once: (N, S, 3, 3).
    sym_R = poses[:, None, :3, :3] @ symmetry_tfs[None, :, :3, :3]

    kept: list[int] = [0]
    kept_R = poses[0:1, :3, :3]
    kept_t = poses[0:1, :3, 3]
    for i in range(1, len(poses)):
        t = poses[i, :3, 3]
        close = np.linalg.norm(kept_t - t[None], axis=-1) < dist_diff
        isnew = True
        if close.any():
            cand = kept_R[close]  # (Kc, 3, 3)
            ang = _rotation_geodesic(
                sym_R[i][None, :], cand[:, None]
            )  # (Kc, S)
            if (ang < radian_thres).any():
                isnew = False
        if isnew:
            kept.append(i)
            kept_R = np.concatenate([kept_R, poses[i : i + 1, :3, :3]])
            kept_t = np.concatenate([kept_t, poses[i : i + 1, :3, 3]])
    return poses[np.array(kept)]


def cluster_poses(
    angle_diff_deg: float,
    dist_diff: float,
    poses: np.ndarray,
    symmetry_tfs: np.ndarray | None = None,
) -> np.ndarray:
    """Native C++ implementation when available, numpy otherwise."""
    lib = _load_native()
    if lib is None:
        return cluster_poses_numpy(angle_diff_deg, dist_diff, poses, symmetry_tfs)
    if symmetry_tfs is None:
        symmetry_tfs = np.eye(4)[None]
    poses32 = np.ascontiguousarray(poses, dtype=np.float32)
    sym32 = np.ascontiguousarray(symmetry_tfs, dtype=np.float32)
    out = np.zeros(len(poses32), dtype=np.int32)
    n = lib.cluster_poses(
        ctypes.c_float(angle_diff_deg),
        ctypes.c_float(dist_diff),
        poses32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(poses32),
        sym32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(sym32),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return np.asarray(poses, dtype=np.float64)[out[:n]]
