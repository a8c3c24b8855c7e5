"""Depth preprocessing stencils on torch tensors.

Port of foundationpose_tpu/ops/depth_filters.py: each 5x5 stencil is the
stack of its (2r+1)^2 shifted windows, and only in-image neighbours count.
Both filters take one (H, W) frame or a batch (..., H, W) of them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import torch_config  # noqa: F401


def _window_stack(x: torch.Tensor, radius: int, fill: float):
    """(..., H, W) -> shifted windows (k*k, ..., H, W) and their in-image
    mask (k*k, H, W), broadcast over the leading dims. A batch of frames
    gives each frame what it gives alone."""
    H, W = x.shape[-2:]
    k = 2 * radius + 1
    lead = x.shape[:-2]
    xp = F.pad(x.reshape(-1, 1, H, W), (radius,) * 4, value=fill)[:, 0]
    xp = xp.reshape(*lead, H + 2 * radius, W + 2 * radius)
    mp = F.pad(
        torch.ones((1, 1, H, W), dtype=torch.float32, device=x.device),
        (radius,) * 4,
        value=0.0,
    )[0, 0] > 0
    wins = [xp[..., dv : dv + H, du : du + W] for dv in range(k) for du in range(k)]
    masks = [mp[dv : dv + H, du : du + W] for dv in range(k) for du in range(k)]
    masks = torch.stack(masks).reshape(k * k, *([1] * len(lead)), H, W)
    return torch.stack(wins), masks


def erode_depth(
    depth: torch.Tensor,
    radius: int = 2,
    depth_diff_thres: float = 0.001,
    ratio_thres: float = 0.8,
    zfar: float = 100.0,
) -> torch.Tensor:
    """Zero out pixels whose neighbourhood is mostly discontinuous: a
    neighbour is bad if invalid or farther than depth_diff_thres from the
    center; zero when bad/total > ratio_thres over in-image neighbours."""
    depth = depth.to(torch.float32)
    wins, inb = _window_stack(depth, radius, 0.0)
    bad = (wins < 0.001) | (wins >= zfar) | (torch.abs(wins - depth[None]) > depth_diff_thres)
    bad_cnt = torch.sum((inb & bad).to(torch.float32), dim=0)
    total = torch.sum(inb.to(torch.float32), dim=0)
    return torch.where(bad_cnt / total > ratio_thres, torch.zeros_like(depth), depth)


def bilateral_filter_depth(
    depth: torch.Tensor,
    radius: int = 2,
    zfar: float = 100.0,
    sigma_d: float = 2.0,
    sigma_r: float = 100000.0,
) -> torch.Tensor:
    """Depth-aware bilateral smoothing with a local-mean outlier gate;
    holes are filled when valid neighbours exist."""
    depth = depth.to(torch.float32)
    r = radius
    k = 2 * r + 1
    wins, inb = _window_stack(depth, r, 0.0)
    valid = inb & (wins >= 0.001) & (wins < zfar)
    num_valid = torch.sum(valid.to(torch.float32), dim=0)
    zero = torch.zeros_like(wins)
    mean_depth = torch.sum(torch.where(valid, wins, zero), dim=0) / torch.clamp(
        num_valid, min=1.0
    )

    offs = torch.arange(k, dtype=torch.float32, device=depth.device) - r
    dv, du = torch.meshgrid(offs, offs, indexing="ij")
    w_spatial = torch.exp(-(du**2 + dv**2) / (2.0 * sigma_d**2))
    w_spatial = w_spatial.reshape(-1, *([1] * depth.ndim))

    near_mean = torch.abs(wins - mean_depth[None]) < 0.01
    use = valid & near_mean
    w_range = torch.exp(-((depth[None] - wins) ** 2) / (2.0 * sigma_r**2))
    w = torch.where(use, w_spatial * w_range, zero)
    sum_w = torch.sum(w, dim=0)
    out = torch.sum(w * wins, dim=0) / torch.clamp(sum_w, min=1e-12)
    return torch.where((sum_w > 0) & (num_valid > 0), out, torch.zeros_like(out))
