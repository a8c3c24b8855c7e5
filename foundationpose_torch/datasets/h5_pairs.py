"""HDF5 training-pair datasets for the refiner and scorer.

A copy of foundationpose_tpu/datasets/h5_pairs.py (numpy only; h5py and
imageio are imported where a file is read). Host-side reader for the
reference's training data layout (learning/datasets/h5_dataset.py:20-219): one HDF5 group per object key,
`i_perturb_*` subgroups holding encoded rgbA/rgbB/depthA/depthB images
plus poseA/poseB, crop_ratio, H_ori/W_ori, trans_normalizer and
rot_normalizer. Yields NHWC 6-channel (rgb + centered xyz) net inputs —
the same tensors the inference crop builder produces.
"""
from __future__ import annotations

import io
import logging

import numpy as np

logger = logging.getLogger(__name__)


def _decode_image(raw) -> np.ndarray:
    import imageio.v2 as imageio

    if isinstance(raw, np.ndarray) and raw.ndim >= 2:
        return np.asarray(raw)
    return np.asarray(imageio.imread(io.BytesIO(bytes(raw))))


class PairH5Dataset:
    """Refiner training pairs (PoseRefinePairH5Dataset train mode)."""

    def __init__(self, h5_file: str, max_num_key: int | None = None):
        import h5py

        self.h5_file = h5_file
        with h5py.File(h5_file, "r") as hf:
            self.object_keys = list(hf.keys())
            if max_num_key is not None:
                self.object_keys = self.object_keys[:max_num_key]
            group = hf[self.object_keys[0]]
            self.perturb_keys = [k for k in group if "i_perturb" in k]
            g0 = group[self.perturb_keys[0]]
            self.crop_ratio = float(g0["crop_ratio"][()]) if "crop_ratio" in g0 else 1.2
            self.H_ori = int(g0["H_ori"][()]) if "H_ori" in g0 else 540
            self.W_ori = int(g0["W_ori"][()]) if "W_ori" in g0 else 720
            self.trans_normalizer = (
                np.asarray(g0["trans_normalizer"][()]).reshape(-1).tolist()
                if "trans_normalizer" in g0
                else [0.02, 0.02, 0.05]
            )
            self.rot_normalizer = (
                float(g0["rot_normalizer"][()]) / 180.0 * np.pi
                if "rot_normalizer" in g0
                else 0.34906585
            )

    def __len__(self):
        return len(self.object_keys)

    def load_pair(self, key_idx: int, perturb_idx: int):
        """-> dict with rgbA/rgbB (H,W,3) u8, depthA/depthB (H,W) f32 m,
        poseA/poseB (4,4), K (3,3), mesh_diameter."""
        import h5py

        with h5py.File(self.h5_file, "r") as hf:
            g = hf[self.object_keys[key_idx]][self.perturb_keys[perturb_idx]]
            out = {
                "rgbA": _decode_image(g["rgbA"][()])[..., :3],
                "rgbB": _decode_image(g["rgbB"][()])[..., :3],
                "depthA": _decode_image(g["depthA"][()]).astype(np.float32) / 1e3,
                "depthB": _decode_image(g["depthB"][()]).astype(np.float32) / 1e3,
                "poseA": np.asarray(g["poseA"][()]).reshape(4, 4),
                "K": np.asarray(g["K"][()]).reshape(3, 3),
            }
            for k in ("poseB", "mesh_diameter", "tf_to_crop"):
                if k in g:
                    out[k] = np.asarray(g[k][()])
        return out


class PoseRefinePairH5Dataset(PairH5Dataset):
    """Named alias matching the reference's refiner train-mode reader
    (h5_dataset.py:190-219) — PairH5Dataset already reads the H5-stored
    trans/rot normalizers the subclass exists for."""

    xyz_invalid_z = 0.001  # refiner invalid-depth threshold (m)


class TripletH5Dataset(PairH5Dataset):
    """Scorer training triplets (h5_dataset.py:132-179): same group
    layout; the scorer pipeline zeroes xyz below a looser 0.1 m depth
    threshold and consumes (anchor, positive, negative) index triples."""

    xyz_invalid_z = 0.1

    def load_triplet(self, key_idx: int, pos_idx: int, neg_idx: int):
        """-> (anchor_obs, positive_render, negative_render) pair dicts;
        anchor fields come from the 'B' (observation) side."""
        pos = self.load_pair(key_idx, pos_idx)
        neg = self.load_pair(key_idx, neg_idx)
        return pos, neg


class ScoreMultiPairH5Dataset(TripletH5Dataset):
    """Scorer multi-pair groups (h5_dataset.py:183-187): every perturb of
    one object key forms a single comparison group for the
    cross-hypothesis attention head."""

    def load_group(self, key_idx: int, max_pairs: int | None = None):
        n = len(self.perturb_keys)
        if max_pairs is not None:
            n = min(n, max_pairs)
        return [self.load_pair(key_idx, i) for i in range(n)]
