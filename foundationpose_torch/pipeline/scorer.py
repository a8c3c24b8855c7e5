"""Hypothesis scoring: all N refined hypotheses in one comparison group.

Port of foundationpose_tpu/pipeline/scorer.py (the reference's
ScorePredictor.predict, predict_score.py:160-226), network and depth
modes and the chunked tournament for more hypotheses than one group.
"""
from __future__ import annotations

import torch

from .. import torch_config  # noqa: F401
from ..utils import profiling
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


def _crops(cfg: ScorerCfg, mesh, poses, K, rgb, xyz_map, mesh_diameter):
    return make_crop_inputs(
        mesh, poses, K, rgb, xyz_map, mesh_diameter,
        input_res=cfg.input_res,
        crop_ratio=cfg.crop_ratio,
        normalize_xyz=cfg.normalize_xyz,
        invalid_z=cfg.xyz_invalid_z,
        use_normal=cfg.use_normal,
        raster=cfg.raster,
    )[:2]


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
    if cfg.mode not in ("depth", "network"):
        raise ValueError(f"scorer mode {cfg.mode!r} (resolve 'auto' in the estimator)")
    profiling.mark("score.crops")
    a, b = _crops(cfg, mesh, poses, K, rgb, xyz_map, mesh_diameter)
    profiling.mark("score.net")
    if cfg.mode == "depth":
        scores = _depth_alignment_scores(a, b)
    else:
        scores = net(a, b, torch_dtype(cfg.compute_dtype))
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    return scores


@torch.inference_mode()
def score_poses_tournament(
    net,
    cfg: ScorerCfg,
    mesh: MeshTensors,
    poses: torch.Tensor,
    K: torch.Tensor,
    rgb: torch.Tensor,
    xyz_map: torch.Tensor,
    mesh_diameter,
    valid: torch.Tensor | None = None,
    group_size: int = 252,
) -> torch.Tensor:
    """Hierarchical tournament for hypothesis sets larger than one group.

    The reference ScorePredictor's while-loop (predict_score.py:202-213):
    hypotheses are scored in chunks of `group_size` (the last padded by
    repeating the first rows, cyclically when fewer rows than the pad
    are left, marked invalid), each chunk's winner (its first maximum)
    advances, and the final round's scores get +100 so its rows outrank
    everything eliminated earlier, which stays at 0. For
    N <= group_size this is one score_poses pass."""
    N = poses.shape[0]
    if N <= group_size:
        return score_poses(net, cfg, mesh, poses, K, rgb, xyz_map, mesh_diameter, valid=valid)

    dev = poses.device
    scores_global = torch.zeros(N, dtype=torch.float32, device=dev)
    global_ids = torch.arange(N, device=dev)
    cur, cur_valid = poses, valid
    while True:
        n = cur.shape[0]
        if cur_valid is None:
            cur_valid = torch.ones(n, dtype=torch.bool, device=dev)
        pad = (-n) % group_size
        if pad:
            # the JAX package pads with cur[:pad], too few rows when
            # pad > n (it then fails); cyclic repeats are the same rows
            # whenever it does not
            cur = torch.cat([cur, cur[torch.arange(pad, device=dev) % n]])
            cur_valid = torch.cat([cur_valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
        n_chunks = cur.shape[0] // group_size
        scores = torch.cat([
            score_poses(net, cfg, mesh, cur[c * group_size:(c + 1) * group_size], K, rgb,
                        xyz_map, mesh_diameter,
                        valid=cur_valid[c * group_size:(c + 1) * group_size])
            for c in range(n_chunks)
        ])
        if n_chunks == 1:
            scores_global[global_ids] = scores[: len(global_ids)] + 100.0
            return scores_global
        winners = torch.argmax(scores.reshape(n_chunks, group_size), dim=-1)
        winners = winners + torch.arange(n_chunks, device=dev) * group_size
        global_ids = global_ids[winners[winners < n]]
        cur = poses[global_ids]
        cur_valid = valid[global_ids] if valid is not None else None
