"""Dense occupancy grid and occupied-space ray sampling on torch tensors.

Port of foundationpose_tpu/nerf/occupancy.py (which replaces the
reference's kaolin octree, Utils.py:904-993, and the CUDA sampler,
bundlesdf/mycuda/common.cu:42-168). `build_occupancy_grid` is the same
host numpy; the ray functions run on the grid's device and select
samples in the same rank order, with `torch.searchsorted` in place of the
vmapped `jnp.searchsorted`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import torch_config  # noqa: F401


def build_occupancy_grid(points: np.ndarray, voxel_size: float, dilate: int = 1):
    """Boolean (G, G, G) grid over [-1, 1]^3 from a normalized point cloud:
    voxels holding points, dilated over the 27-neighbourhood `dilate`
    times (nerf_runner.py:320-375)."""
    G = int(np.ceil(2.0 / voxel_size))
    idx = np.floor((points + 1.0) / voxel_size).astype(np.int64)
    idx = np.clip(idx, 0, G - 1)
    occ = np.zeros((G, G, G), dtype=bool)
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    for _ in range(dilate):
        p = np.pad(occ, 1)
        acc = np.zeros_like(occ)
        for dx in (0, 1, 2):
            for dy in (0, 1, 2):
                for dz in (0, 1, 2):
                    acc |= p[dx : dx + G, dy : dy + G, dz : dz + G]
        occ = acc
    return occ


def ray_box_intersection(rays_o: torch.Tensor, rays_d: torch.Tensor, bound: float = 1.0):
    """Slab test against [-bound, bound]^3 (nerf_helpers.py:432-475);
    t in units of |rays_d|. Returns (tmin clipped at 0, tmax, hit)."""
    inv_d = 1.0 / torch.where(torch.abs(rays_d) < 1e-12, 1e-12, rays_d)
    t0 = (-bound - rays_o) * inv_d
    t1 = (bound - rays_o) * inv_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    tmin = torch.maximum(tmin, torch.zeros_like(tmin))  # jnp.maximum's gradient at ties
    return tmin, tmax, tmax > tmin


def occupancy_lookup(occ: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """occ (G, G, G) bool, pts (..., 3) in [-1, 1] -> (...,) bool."""
    G = occ.shape[0]
    idx = torch.floor((pts + 1.0) / (2.0 / G)).to(torch.int64)
    inb = torch.all((idx >= 0) & (idx < G), dim=-1)
    idx = torch.clamp(idx, 0, G - 1)
    return occ[idx[..., 0], idx[..., 1], idx[..., 2]] & inb


def sample_occupied(
    occ: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    n_samples: int,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    depth: torch.Tensor | None = None,
    trunc: float = 0.0,
    far_clip: float = float("inf"),
    candidate_mult: int = 4,
):
    """Uniform samples inside occupied voxels along each ray.

    rays_o, rays_d (N, 3) in the normalized object frame (t multiplies
    rays_d). A coarse pass of n_samples probes finds each ray's occupied
    span; M = candidate_mult * n_samples stratified candidates inside it,
    jittered by `u` (N, M) uniforms (drawn from `generator` when None),
    are rank-selected so the n kept samples cover the occupied set evenly.
    Returns (z (N, n) ascending, valid (N, n))."""
    N = rays_o.shape[0]
    M = candidate_mult * n_samples
    dev = rays_o.device
    if u is None:
        u = torch.rand((N, M), generator=generator, device=dev)
    tmin, tmax, hit = ray_box_intersection(rays_o, rays_d)
    teff = tmax
    if depth is not None:
        has_d = (depth > 1e-6) & (depth <= far_clip)
        teff = torch.where(has_d, torch.minimum(tmax, depth + trunc), tmax)
    teff = torch.maximum(teff, tmin + 1e-6)

    # Phase 1: coarse probes locate the occupied span of each ray.
    Mc = n_samples
    uc = (torch.arange(Mc, dtype=torch.float32, device=dev)[None] + 0.5) / Mc
    t_coarse = tmin[:, None] + (teff - tmin)[:, None] * uc
    pts_c = rays_o[:, None] + rays_d[:, None] * t_coarse[..., None]
    occ_coarse = occupancy_lookup(occ, pts_c) & hit[:, None]
    any_occ = torch.any(occ_coarse, dim=-1)
    big = 1e30
    t_first = torch.amin(torch.where(occ_coarse, t_coarse, big), dim=-1)
    t_last = torch.amax(torch.where(occ_coarse, t_coarse, -big), dim=-1)
    pad = (teff - tmin) / Mc
    lo = torch.where(any_occ, torch.maximum(t_first - pad, tmin), tmin)
    hi = torch.where(any_occ, torch.minimum(t_last + pad, teff), teff)

    # Phase 2: stratified candidates inside the occupied span.
    u = (torch.arange(M, dtype=torch.float32, device=dev)[None] + u) / M
    t_cand = lo[:, None] + (hi - lo)[:, None] * u
    pts = rays_o[:, None] + rays_d[:, None] * t_cand[..., None]
    occ_c = occupancy_lookup(occ, pts) & hit[:, None]

    # Rank-select n evenly spaced occupied candidates per ray.
    counts = occ_c.sum(dim=-1)
    csum = torch.cumsum(occ_c.to(torch.int32), dim=-1).to(torch.int32)
    target = (
        torch.floor(
            (torch.arange(n_samples, dtype=torch.float32, device=dev)[None] + 0.5)
            * counts[:, None].to(torch.float32)
            / n_samples
        ).to(torch.int32)
        + 1
    )
    sel = torch.searchsorted(csum, target, side="left").clamp(0, M - 1)
    z = torch.gather(t_cand, 1, sel)
    valid = torch.arange(n_samples, device=dev)[None] < torch.clamp(counts[:, None], max=n_samples)
    valid = valid & hit[:, None]
    z = torch.where(valid, z, teff[:, None])
    return z, valid
