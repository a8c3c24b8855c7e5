"""Typed configuration of the estimator pipeline.

Port of foundationpose_tpu/pipeline/config.py, holding the fields this
package implements: the unpacked full-frame register and track. The
upload-packing, ROI-window and prune fields come back with the features.
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


def torch_dtype(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
