"""Object symmetry transforms from BOP models_info (host-side numpy).

Replaces Utils.py:806-834; a copy of foundationpose_tpu/geometry/symmetry.py.
"""
from __future__ import annotations

import numpy as np


def _euler_single_axis(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation 4x4 for at-most-one nonzero axis (all BOP continuous
    symmetries are single-axis, so composition order is irrelevant;
    Utils.py:825-830)."""
    out = np.eye(4)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    out[:3, :3] = Rz @ Ry @ Rx
    return out


def symmetry_tfs_from_info(info: dict, rot_angle_discrete: float = 5) -> np.ndarray:
    """(S, 4, 4) symmetry transforms from a BOP models_info entry.

    Discrete symmetries come in mm and are scaled to meters; continuous
    ones are discretized every rot_angle_discrete degrees about the given
    axis (Utils.py:806-834).
    """
    symmetry_tfs = [np.eye(4)]
    if "symmetries_discrete" in info:
        tfs = np.array(info["symmetries_discrete"], dtype=np.float64).reshape(-1, 4, 4)
        tfs[..., :3, 3] *= 0.001
        symmetry_tfs = [np.eye(4)] + list(tfs)
    if "symmetries_continuous" in info:
        axis = np.array(info["symmetries_continuous"][0]["axis"]).reshape(3)
        offset = info["symmetries_continuous"][0]["offset"]
        angles = np.arange(0, 360, rot_angle_discrete) / 180.0 * np.pi
        rxs, rys, rzs = [0.0], [0.0], [0.0]
        if axis[0] > 0:
            rxs = angles
        elif axis[1] > 0:
            rys = angles
        elif axis[2] > 0:
            rzs = angles
        for rx in rxs:
            for ry in rys:
                for rz in rzs:
                    tf = _euler_single_axis(rx, ry, rz)
                    tf[:3, 3] = offset
                    symmetry_tfs.append(tf)
    return np.array(symmetry_tfs)
