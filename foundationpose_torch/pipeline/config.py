"""Typed configuration of the estimator pipeline.

Port of foundationpose_tpu/pipeline/config.py, with the JAX package's
defaults, so `FoundationPose()` computes the same thing in both: the
register (with the optional prune funnel) and the tracker upload each
frame as one packed buffer (rgb u8 + depth as u16 0.25 mm fixed point,
plus a mask bit plane for the register) holding only a window around
the object, and fall back to the full frame where the object outruns
the window.
"""
from __future__ import annotations

import dataclasses

from ..models.networks import RefineNetCfg, ScoreNetCfg


@dataclasses.dataclass(frozen=True)
class RasterCfg:
    # exact speedup for closed, consistently wound meshes
    cull_backfaces: bool = False


@dataclasses.dataclass(frozen=True)
class RefinerCfg:
    net: RefineNetCfg = dataclasses.field(default_factory=RefineNetCfg)
    input_res: int = 160
    crop_ratio: float = 1.2
    # Delta parameterization of the released refiner checkpoints
    # (predict_pose_refine.py:195-231).
    trans_rep: str = "tracknet"  # or "deepim"
    rot_rep: str = "axis_angle"  # or "6d"
    normalize_xyz: bool = True
    trans_normalizer: tuple[float, float, float] = (0.02, 0.02, 0.05)
    rot_normalizer: float = 0.34906585  # 20 degrees in radians
    xyz_invalid_z: float = 0.001
    # 3 extra raw normal channels on A/B (c_in=9 nets).
    use_normal: bool = False
    compute_dtype: str = "bfloat16"
    raster: RasterCfg = dataclasses.field(default_factory=RasterCfg)


@dataclasses.dataclass(frozen=True)
class ScorerCfg:
    net: ScoreNetCfg = dataclasses.field(default_factory=ScoreNetCfg)
    input_res: int = 160
    crop_ratio: float = 1.2
    normalize_xyz: bool = True
    xyz_invalid_z: float = 0.1
    use_normal: bool = False
    # "auto": network when scorer weights are given, the classical depth
    # alignment otherwise; or force "network" / "depth".
    mode: str = "auto"
    compute_dtype: str = "bfloat16"
    raster: RasterCfg = dataclasses.field(default_factory=RasterCfg)


@dataclasses.dataclass(frozen=True)
class EstimatorCfg:
    refiner: RefinerCfg = dataclasses.field(default_factory=RefinerCfg)
    scorer: ScorerCfg = dataclasses.field(default_factory=ScorerCfg)
    min_n_views: int = 40
    inplane_step_deg: float = 60.0
    cluster_angle_deg: float = 30.0
    rot_grid_pad: int = 4  # pad the hypothesis count to a multiple of this
    max_tex_size: int | None = None
    # Decimate the render mesh below this face count (None = never).
    max_render_faces: int | None = 8192
    # Bake textures to per-vertex colors for hypothesis rendering.
    vertex_color_render: bool = True
    zfar: float = float("inf")
    # Tracking upload window: each tracking frame is cut on the host to a
    # square around the last fetched pose before upload, and K's
    # principal point is shifted by the window offset (an exact change of
    # viewport: all pipeline geometry flows through K). Size: the
    # projected crop extent x track_roi_margin + the filter halo, rounded
    # up to 64 px. Each fetch checks that the refined pose's crop stayed
    # inside the window and re-runs the frame full-frame otherwise.
    # False uploads full frames.
    track_roi: bool = True
    track_roi_margin: float = 1.8
    # One flat upload per tracking frame: rgb u8 + depth as u16 0.25 mm
    # fixed point + the window offset (pipeline/graph.py::pack_track_frame;
    # quantization <= 0.125 mm). False uploads rgb and f32 depth apart.
    track_pack: bool = True
    # The same wire format for register uploads, with the mask as a bit
    # plane (pack_register_frame).
    register_pack: bool = True
    # Upload only a detection-sized window for register (needs
    # register_pack): a square around the mask covering the projected crop
    # extent x register_roi_margin. After the run every valid refined
    # hypothesis's crop is checked against the window, and the frame
    # re-runs full-frame when one left it.
    register_roi: bool = True
    register_roi_margin: float = 1.8
    # Hypothesis funneling (off by default = reference-parity register):
    # refine all hypotheses for `prune_after_iter` iterations, rank them
    # with the weights-free depth-alignment score, then run the remaining
    # iterations and the configured scorer on the top `prune_keep` only.
    # An approximation: a pruned hypothesis can no longer win.
    prune_after_iter: int | None = None
    prune_keep: int = 64

    def fast_register(self) -> "EstimatorCfg":
        """The funneled-register preset: refine all hypotheses for 2
        iterations, keep the top 64 by depth alignment, and spend
        iterations 3-5 and the scorer on the survivors only.

        It renders and refines 64 instead of 252 poses in the last three
        iterations and scores 64 with the network; its time on the card
        is measured beside the full register's by chip_smoke.py. The
        pruning rank is the weights-free depth score, so a hypothesis
        the RefineNet could still have rescued in iterations 3-5 can be
        lost: keep the parity default for benchmark comparisons.
        """
        return dataclasses.replace(self, prune_after_iter=2, prune_keep=64)


def torch_dtype(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
