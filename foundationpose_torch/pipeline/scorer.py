"""Hypothesis scoring: all N refined hypotheses in one comparison group.

Port of foundationpose_tpu/pipeline/scorer.py (the reference's
ScorePredictor.predict, predict_score.py:160-226), network and depth
modes. The chunked tournament for more than 252 hypotheses is not
ported yet.
"""
from __future__ import annotations

import torch

from .. import torch_config  # noqa: F401
from .config import ScorerCfg, torch_dtype
from .crops import make_crop_inputs
from .mesh_tensors import MeshTensors


def _depth_alignment_scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Classical score: negative masked distance between rendered and
    observed centered-XYZ crops plus an overlap reward. No weights."""
    xyz_a = a[..., 3:6]
    xyz_b = b[..., 3:6]
    valid_a = torch.any(torch.abs(xyz_a) > 1e-6, dim=-1)
    valid_b = torch.any(torch.abs(xyz_b) > 1e-6, dim=-1)
    both = valid_a & valid_b
    either = valid_a | valid_b
    d = torch.linalg.norm(xyz_a - xyz_b, dim=-1)
    n_both = torch.sum(both, dim=(1, 2)).to(torch.float32)
    n_either = torch.clamp(torch.sum(either, dim=(1, 2)).to(torch.float32), min=1.0)
    mean_d = torch.sum(torch.where(both, d, torch.zeros_like(d)), dim=(1, 2)) / torch.clamp(
        n_both, min=1.0
    )
    # A hypothesis with no overlap ranks below any overlapping one.
    mean_d = torch.where(n_both > 0, mean_d, torch.full_like(mean_d, 1e3))
    return n_both / n_either - mean_d * 10.0


@torch.inference_mode()
def score_poses(
    net,
    cfg: ScorerCfg,
    mesh: MeshTensors,
    poses: torch.Tensor,  # (N, 4, 4)
    K: torch.Tensor,
    rgb: torch.Tensor,
    xyz_map: torch.Tensor,
    mesh_diameter,
    valid: torch.Tensor | None = None,  # (N,) mask of real hypotheses
) -> torch.Tensor:
    """(N,) logits, higher is better; -inf where `valid` is False. `net`
    is the ScoreNetMultiPair (unused in depth mode)."""
    a, b, _tf = make_crop_inputs(
        mesh, poses, K, rgb, xyz_map, mesh_diameter,
        input_res=cfg.input_res,
        crop_ratio=cfg.crop_ratio,
        normalize_xyz=cfg.normalize_xyz,
        invalid_z=cfg.xyz_invalid_z,
        use_normal=cfg.use_normal,
        raster=cfg.raster,
    )
    if cfg.mode == "depth":
        scores = _depth_alignment_scores(a, b)
    elif cfg.mode == "network":
        scores = net(a, b, dtype=torch_dtype(cfg.compute_dtype))
    else:
        raise ValueError(f"scorer mode {cfg.mode!r} (resolve 'auto' in the estimator)")
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    return scores
