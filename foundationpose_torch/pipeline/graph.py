"""The register and track bodies: everything a frame computes on device.

Port of foundationpose_tpu/pipeline/graph.py (`_register_body` with
its prune funnel, `_track_body`, `device_guess_translation`). PyTorch
runs eagerly, so each body is a plain function of tensors; no step
copies a value to the host.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import torch_config  # noqa: F401
from ..geometry.projection import depth_to_xyz_map
from ..ops.depth_filters import bilateral_filter_depth, erode_depth
from .config import EstimatorCfg
from .mesh_tensors import MeshTensors
from .refiner import refine_poses
from .scorer import score_poses


def device_guess_translation(depth: torch.Tensor, mask: torch.Tensor, K: torch.Tensor):
    """Mask-bbox center ray x masked median depth. Returns (center (3,),
    n_valid).

    The median is the JAX package's two-pass 256-bin counting bisection
    (each pass narrows the range 256x with one (pixels x 256) compare),
    reproduced step for step: torch.median takes another order statistic."""
    H, W = depth.shape
    dev = depth.device
    m = mask > 0
    valid = m & (depth >= 0.001)
    col_any = torch.any(m, dim=0)
    row_any = torch.any(m, dim=1)
    ui = torch.arange(W, dtype=torch.float32, device=dev)
    vi = torch.arange(H, dtype=torch.float32, device=dev)
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    umin = torch.amin(torch.where(col_any, ui, big))
    umax = torch.amax(torch.where(col_any, ui, -big))
    vmin = torch.amin(torch.where(row_any, vi, big))
    vmax = torch.amax(torch.where(row_any, vi, -big))
    uc = (umin + umax) / 2.0
    vc = (vmin + vmax) / 2.0

    vals = depth.reshape(-1).to(torch.float32)
    vmask = valid.reshape(-1)
    n = torch.sum(vmask).to(torch.int32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    lo0 = torch.amin(torch.where(vmask, vals, inf))
    hi0 = torch.amax(torch.where(vmask, vals, -inf))
    edges = torch.arange(1, 257, dtype=torch.float32, device=dev) / 256.0

    def kth(k):
        lo, hi = lo0, hi0
        for _ in range(2):
            t = lo + (hi - lo) * edges  # (256,) upper bin edges
            cnt = torch.sum(vmask[:, None] & (vals[:, None] <= t[None]), dim=0)
            b = torch.argmax((cnt > k).to(torch.int32))  # first bin past k
            lo = torch.where(b > 0, t[torch.clamp(b - 1, min=0)], lo)
            hi = t[b]
        return hi

    k1 = torch.clamp((n - 1) // 2, min=0)
    k2 = torch.clamp(n // 2, min=0)
    zc = (kth(k1) + kth(k2)) / 2.0
    # All-invalid mask: the bisection yields NaN; pin it before it feeds
    # the ray math.
    zc = torch.where(n > 0, zc, torch.zeros_like(zc))
    x = (uc - K[0, 2]) / K[0, 0] * zc
    y = (vc - K[1, 2]) / K[1, 1] * zc
    center = torch.stack([x, y, zc])
    return torch.where(n > 0, center, torch.zeros_like(center)), n


def _filtered_xyz(depth_raw, K, cfg: EstimatorCfg):
    depth = bilateral_filter_depth(erode_depth(depth_raw, radius=2), radius=2)
    return depth, depth_to_xyz_map(depth, K, zfar=cfg.zfar)


def register_body(
    refiner_net,
    scorer_net,
    cfg: EstimatorCfg,
    mesh: MeshTensors,
    rot_grid: torch.Tensor,  # (N, 4, 4)
    hyp_valid: torch.Tensor,  # (N,)
    K: torch.Tensor,
    rgb: torch.Tensor,  # (H, W, 3) f32 [0, 1]
    depth_raw: torch.Tensor,  # (H, W) f32 meters
    mask: torch.Tensor,  # (H, W)
    mesh_diameter,
    iterations: int,
):
    """Full registration. Returns (order, refined_sorted, scores_sorted,
    center, n_valid).

    With cfg.prune_after_iter set (and fewer survivors than hypotheses,
    more iterations than the prune point), the register is funneled:
    every hypothesis is refined `prune_after_iter` times and ranked by
    the depth score; the top `prune_keep` are refined for the remaining
    iterations and scored by the configured scorer."""
    depth, xyz_map = _filtered_xyz(depth_raw, K, cfg)
    center, n_valid = device_guess_translation(depth, mask, K)
    poses = rot_grid.clone()
    poses[:, :3, 3] = center[None]
    n_hyp = rot_grid.shape[0]
    prune = (
        cfg.prune_after_iter is not None
        and iterations > cfg.prune_after_iter
        and cfg.prune_keep < n_hyp
    )

    def refine(p, n):
        return refine_poses(refiner_net, cfg.refiner, mesh, p, K, rgb, xyz_map,
                            mesh_diameter, iterations=n)

    def score(scfg, p, valid):
        return score_poses(scorer_net, scfg, mesh, p, K, rgb, xyz_map, mesh_diameter,
                           valid=valid)

    if not prune:
        refined = refine(poses, iterations)
        scores = score(cfg.scorer, refined, hyp_valid)
        # stable, as jnp.argsort: padded hypotheses all hold -inf
        order = torch.argsort(-scores, stable=True)
        return order, refined[order], scores[order], center, n_valid

    refined1 = refine(poses, cfg.prune_after_iter)
    pre = score(dataclasses.replace(cfg.scorer, mode="depth"), refined1, hyp_valid)
    keep_idx = funnel_keep(pre, cfg.prune_keep)
    sub_refined = refine(refined1[keep_idx], iterations - cfg.prune_after_iter)
    sub_scores = score(cfg.scorer, sub_refined, hyp_valid[keep_idx])
    refined = refined1.index_copy(0, keep_idx, sub_refined)
    order, scores = funnel_order(pre, sub_scores, keep_idx, hyp_valid)
    return order, refined[order], scores[order], center, n_valid


def funnel_keep(pre: torch.Tensor, keep: int) -> torch.Tensor:
    """The `keep` survivors: highest depth score first, the lower index
    first on a tie, as jax.lax.top_k orders them (torch.topk gives no tie
    order on CUDA)."""
    return torch.argsort(-pre, stable=True)[:keep]


def funnel_order(pre, sub_scores, keep_idx, hyp_valid):
    """(order (N,), scores (N,)) of a funneled register.

    Survivors come first, by their final score (-inf where invalid);
    then the pruned rows, valid ones by descending depth score, invalid
    ones under the finite key -3e38 so they still sort above the
    survivors' -inf keys and the first N - keep entries are exactly the
    pruned rows. Reported survivor scores carry +1e5 so callers see them
    above every pruned row; the order is computed here, never through
    that offset (+1e5 rounds f32 logits to ~0.008)."""
    n_keep = keep_idx.shape[0]
    neg_inf = torch.tensor(float("-inf"), dtype=pre.dtype, device=pre.device)
    scores = pre.index_copy(0, keep_idx, sub_scores + 1e5)
    surv_key = torch.where(hyp_valid[keep_idx], sub_scores, neg_inf)
    surv_ids = keep_idx[torch.argsort(-surv_key, stable=True)]
    rest_key = torch.where(hyp_valid, pre, torch.full_like(pre, -3e38))
    rest_key = rest_key.index_fill(0, keep_idx, float("-inf"))
    rest_ids = torch.argsort(-rest_key, stable=True)[: pre.shape[0] - n_keep]
    return torch.cat([surv_ids, rest_ids]), scores


def track_body(refiner_net, cfg: EstimatorCfg, mesh, pose_last, K, rgb, depth_raw,
               mesh_diameter, iterations):
    """One tracking step: refine the last pose on the new frame."""
    _depth, xyz_map = _filtered_xyz(depth_raw, K, cfg)
    refined = refine_poses(
        refiner_net, cfg.refiner, mesh, pose_last[None], K, rgb, xyz_map,
        mesh_diameter, iterations=iterations,
    )
    return refined[0]
