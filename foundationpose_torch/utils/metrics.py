"""Pose-accuracy metrics (host-side numpy; Utils.py:232-266).

A copy of foundationpose_tpu/utils/metrics.py.
"""
from __future__ import annotations

import numpy as np


def _transform(pts: np.ndarray, tf: np.ndarray) -> np.ndarray:
    return pts @ tf[:3, :3].T + tf[:3, 3]


def add_err(pred: np.ndarray, gt: np.ndarray, model_pts: np.ndarray) -> float:
    """ADD: mean distance between corresponding model points."""
    e = np.linalg.norm(_transform(model_pts, pred) - _transform(model_pts, gt), axis=-1)
    return float(e.mean())


def adds_err(pred: np.ndarray, gt: np.ndarray, model_pts: np.ndarray) -> float:
    """ADD-S: mean nearest-neighbor distance (symmetric objects)."""
    from scipy.spatial import cKDTree

    pred_pts = _transform(model_pts, pred)
    gt_pts = _transform(model_pts, gt)
    nn_dists, _ = cKDTree(pred_pts).query(gt_pts, k=1)
    return float(nn_dists.mean())


def rotation_geodesic_deg(pred: np.ndarray, gt: np.ndarray) -> float:
    c = (np.trace(pred[:3, :3] @ gt[:3, :3].T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def compute_auc(errs, max_val: float = 0.1, step: float = 0.001) -> float:
    """Area under the accuracy-vs-threshold curve, normalized to [0, 1]
    (Utils.py:255-266 semantics, trapezoidal integration)."""
    errs = np.sort(np.asarray(errs, dtype=np.float64))
    X = np.arange(0, max_val + step, step)
    Y = np.ones(len(X))
    for i, x in enumerate(X):
        y = (errs <= x).sum() / max(len(errs), 1)
        Y[i] = y
        if y >= 1:
            break
    return float(np.trapezoid(Y, X) / max_val)
