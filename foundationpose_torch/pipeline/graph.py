"""The register and track bodies: everything a frame computes on device.

Port of foundationpose_tpu/pipeline/graph.py: `register_body` with its
prune funnel, `track_body`, `device_guess_translation`, the upload wire
formats (`pack_track_frame`, `pack_register_frame` on the host, their
inverses on the device), the packed bodies and `track_chain_graph`.
Each body is a plain function of tensors, run eagerly; no step copies a
value to the host. `register_graph`, `register_graph_packed`,
`track_graph` and `track_graph_packed`, as the JAX package jit-compiles
them, run their body as one captured step (`step_graphs.py`: a CUDA graph
per static shape, replayed per call; a register step runs eagerly at its
first call and is captured at its second); `TrackChain` replays one
tracking step once per frame: the counterpart of the JAX package's
`lax.scan` over staged frames.

The bodies mark their device stages for `utils/profiling.py`: `prep`
(unpack, depth filters, xyz map, translation guess), per refine iteration
`crops`, `refiner` and `update` (refiner.py), `score.crops` and
`score.net` (scorer.py) and `rank` (the argsorts and the funnel's order).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import torch_config  # noqa: F401
from ..geometry.projection import depth_to_xyz_map
from ..ops.depth_filters import bilateral_filter_depth, erode_depth
from ..utils import profiling
from .config import EstimatorCfg
from .refiner import refine_poses
from .scorer import score_poses
from .step_graphs import StepGraphs, run_step


def device_guess_translation(depth: torch.Tensor, mask: torch.Tensor, K: torch.Tensor):
    """Mask-bbox center ray x masked median depth. Returns (center (3,),
    n_valid).

    The median is the JAX package's two-pass 256-bin counting bisection
    (each pass narrows the range 256x by the count of valid depths at
    or below each of 256 edges), reproduced step for step: torch.median
    takes another order statistic.
    Constants are filled on the device and bins picked by index_select,
    so a register step captures it: no host copy, no host read."""
    H, W = depth.shape
    dev = depth.device
    m = mask > 0
    valid = m & (depth >= 0.001)
    col_any = torch.any(m, dim=0)
    row_any = torch.any(m, dim=1)
    ui = torch.arange(W, dtype=torch.float32, device=dev)
    vi = torch.arange(H, dtype=torch.float32, device=dev)
    big = torch.full((), 1e9, dtype=torch.float32, device=dev)
    umin = torch.amin(torch.where(col_any, ui, big))
    umax = torch.amax(torch.where(col_any, ui, -big))
    vmin = torch.amin(torch.where(row_any, vi, big))
    vmax = torch.amax(torch.where(row_any, vi, -big))
    uc = (umin + umax) / 2.0
    vc = (vmin + vmax) / 2.0

    vals = depth.reshape(-1).to(torch.float32)
    vmask = valid.reshape(-1)
    n = torch.sum(vmask).to(torch.int32)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    lo0 = torch.amin(torch.where(vmask, vals, inf))
    hi0 = torch.amax(torch.where(vmask, vals, -inf))
    edges = torch.arange(1, 257, dtype=torch.float32, device=dev) / 256.0
    # The JAX package counts the valid depths <= each edge as (pixels x
    # 256) compares summed, which here would cast them to an int64
    # temporary (600 MiB at 640 x 480). The same counts: the valid depths
    # sorted, every other pixel +inf after them, and a binary search per
    # edge, capped at n (+inf <= t only where t is +inf, where every
    # valid depth counts). The edges are NaN only when every valid depth
    # is +inf: then the count reads n where the compares read 0, and
    # either way the first bin is taken.
    ranked = torch.sort(torch.where(vmask, vals, inf)).values

    def kth(k):
        lo, hi = lo0, hi0
        for _ in range(2):
            t = lo + (hi - lo) * edges  # (256,) upper bin edges
            cnt = torch.minimum(torch.searchsorted(ranked, t, right=True), n)
            b = torch.argmax((cnt > k).to(torch.int32))  # first bin past k
            below, edge = t.index_select(0, torch.stack([torch.clamp(b - 1, min=0), b]))
            lo = torch.where(b > 0, below, lo)
            hi = edge
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


def register_body(refiner, scorer, mesh, diam, cfg: EstimatorCfg, rot_grid, hyp_valid, K, rgb,
                  depth_raw, mask, iterations: int):
    """Full registration: filter the frame, guess the translation, refine
    every hypothesis of the rotation grid (K1 crops, K2 in RefineNet) and
    score them as one comparison group. Returns (order, refined_sorted,
    scores_sorted, center, n_valid).

    With cfg.prune_after_iter set (and fewer survivors than hypotheses,
    more iterations than the prune point), the register is funneled:
    every hypothesis is refined `prune_after_iter` times and ranked by
    the depth score; the top `prune_keep` are refined for the remaining
    iterations and scored by the configured scorer."""
    profiling.mark("prep")
    depth, xyz_map = _filtered_xyz(depth_raw, K, cfg)
    center, n_valid = device_guess_translation(depth, mask, K)
    poses = rot_grid.clone()
    poses[:, :3, 3] = center[None]

    def refine(p, n):
        return refine_poses(refiner, cfg.refiner, mesh, p, K, rgb, xyz_map, diam, iterations=n)

    def score(scfg, p, valid):
        return score_poses(scorer, scfg, mesh, p, K, rgb, xyz_map, diam, valid=valid)

    if funnel_of(cfg, iterations, rot_grid.shape[0]) is None:
        refined = refine(poses, iterations)
        scores = score(cfg.scorer, refined, hyp_valid)
        profiling.mark("rank")
        # stable, as jnp.argsort: padded hypotheses all hold -inf
        order = torch.argsort(-scores, stable=True)
        return order, refined[order], scores[order], center, n_valid

    refined1 = refine(poses, cfg.prune_after_iter)
    pre = score(dataclasses.replace(cfg.scorer, mode="depth"), refined1, hyp_valid)
    profiling.mark("rank")
    keep_idx = funnel_keep(pre, cfg.prune_keep)
    sub_refined = refine(refined1[keep_idx], iterations - cfg.prune_after_iter)
    sub_scores = score(cfg.scorer, sub_refined, hyp_valid[keep_idx])
    profiling.mark("rank")
    refined = refined1.index_copy(0, keep_idx, sub_refined)
    order, scores = funnel_order(pre, sub_scores, keep_idx, hyp_valid)
    return order, refined[order], scores[order], center, n_valid


def funnel_of(cfg: EstimatorCfg, iterations: int, n_hyp: int):
    """(prune_after_iter, prune_keep) when a register of `iterations` over
    `n_hyp` hypotheses is funneled, else None."""
    if (cfg.prune_after_iter is not None and iterations > cfg.prune_after_iter
            and cfg.prune_keep < n_hyp):
        return cfg.prune_after_iter, cfg.prune_keep
    return None


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
    neg_inf = torch.full((), float("-inf"), dtype=pre.dtype, device=pre.device)
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
    profiling.mark("prep")
    _depth, xyz_map = _filtered_xyz(depth_raw, K, cfg)
    refined = refine_poses(
        refiner_net, cfg.refiner, mesh, pose_last[None], K, rgb, xyz_map,
        mesh_diameter, iterations=iterations,
    )
    return refined[0]


# Fixed-point depth quantum of the packed uploads: 0.25 mm steps (u16 ->
# 16.38 m range), quantization <= 0.125 mm.
DEPTH_PACK_SCALE = 4000.0
TRACK_PACK_FOOTER = 8  # x0_lo, x0_hi, y0_lo, y0_hi + 4 spare bytes
REGISTER_PACK_FOOTER = 8  # the same (x0, y0) footer after the mask bit plane


def _pack_pixels(img, rgb_u8, depth_f32):
    """rgb into bytes 0-2 of each 5-byte pixel, depth as u16 0.25 mm fixed
    point (NaN -> 0 = invalid, + 0.5 rounding, clipped) into bytes 3-4,
    little-endian."""
    img[..., :3] = rgb_u8
    mm = np.clip(np.nan_to_num(depth_f32) * DEPTH_PACK_SCALE + 0.5, 0, 65535).astype(np.uint16)
    img[..., 3] = (mm & 0xFF).astype(np.uint8)
    img[..., 4] = (mm >> 8).astype(np.uint8)


def _footer(x0: int, y0: int):
    return [x0 & 255, x0 >> 8, y0 & 255, y0 >> 8, 0, 0, 0, 0]


def pack_track_frame(rgb_u8, depth_f32, x0: int, y0: int, out=None) -> np.ndarray:
    """Host side: one flat uint8 buffer of an rgb window, its depth as u16
    0.25 mm fixed point and the window offset (x0, y0), byte for byte the
    JAX package's. `out`, if given, is a uint8 array of at least the
    buffer's size (a pinned staging buffer) and the result is a view of it."""
    H, W = depth_f32.shape
    n_img = H * W * 5
    n = n_img + TRACK_PACK_FOOTER
    buf = np.empty(n, np.uint8) if out is None else out[:n]
    _pack_pixels(buf[:n_img].reshape(H, W, 5), rgb_u8, depth_f32)
    buf[n_img:] = _footer(x0, y0)
    return buf


def pack_register_frame(rgb_u8, depth_f32, mask, x0: int = 0, y0: int = 0, out=None) -> np.ndarray:
    """Host side: a register frame as one flat uint8 buffer, byte for byte
    the JAX package's: rgb u8 + depth u16 (5 bytes a pixel), the mask as a
    little-endian bit plane (1 bit a pixel) and the (x0, y0) footer. The
    pixel count must be a multiple of 8. `out` as for pack_track_frame."""
    H, W = depth_f32.shape
    n_px = H * W
    if n_px % 8:
        raise ValueError("frame pixel count must be a multiple of 8")
    n_img = n_px * 5
    n = n_img + n_px // 8 + REGISTER_PACK_FOOTER
    buf = np.empty(n, np.uint8) if out is None else out[:n]
    _pack_pixels(buf[:n_img].reshape(H, W, 5), rgb_u8, depth_f32)
    buf[n_img:-REGISTER_PACK_FOOTER] = np.packbits(
        np.asarray(mask).reshape(-1) != 0, bitorder="little"
    )
    buf[-REGISTER_PACK_FOOTER:] = _footer(x0, y0)
    return buf


def _unpack_pixels(img: torch.Tensor):
    """(..., 5) uint8 pixels -> rgb f32 in [0, 1], depth f32 meters. The
    depth bytes are joined in int32 (torch's uint16 support is partial);
    the values are those of the JAX package's uint16 arithmetic."""
    rgb = img[..., :3].to(torch.float32) / 255.0
    lo = img[..., 3].to(torch.int32)
    hi = img[..., 4].to(torch.int32)
    depth = (lo + hi * 256).to(torch.float32) * (1.0 / DEPTH_PACK_SCALE)
    return rgb, depth


def _offset(foot: torch.Tensor):
    """(..., >= 4) uint8 footer bytes -> x0, y0 as f32."""
    f = foot.to(torch.float32)
    return f[..., 0] + f[..., 1] * 256.0, f[..., 2] + f[..., 3] * 256.0


def unpack_track_frame(buf: torch.Tensor, hw: tuple[int, int]):
    """Device-side inverse of pack_track_frame: (rgb f32 [0, 1], depth f32
    meters, x0, y0)."""
    H, W = hw
    n_img = H * W * 5
    rgb, depth = _unpack_pixels(buf[:n_img].reshape(H, W, 5))
    x0, y0 = _offset(buf[n_img:])
    return rgb, depth, x0, y0


def unpack_register_frame(buf: torch.Tensor, hw: tuple[int, int]):
    """Device-side inverse of pack_register_frame: (rgb f32 [0, 1], depth
    f32 meters, mask uint8 0/1, x0, y0)."""
    H, W = hw
    n_px = H * W
    n_img = n_px * 5
    rgb, depth = _unpack_pixels(buf[:n_img].reshape(H, W, 5))
    bits = buf[n_img:-REGISTER_PACK_FOOTER].to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=buf.device)
    mask = ((bits[:, None] >> shifts[None]) & 1).to(torch.uint8).reshape(H, W)
    x0, y0 = _offset(buf[-REGISTER_PACK_FOOTER:])
    return rgb, depth, mask, x0, y0


def shift_principal_point(K: torch.Tensor, x0, y0) -> torch.Tensor:
    """K with its principal point moved by -(x0, y0): the intrinsics of the
    window at (x0, y0) of the frame. K (..., 3, 3), x0 and y0 (...)."""
    shift = torch.zeros_like(K)
    shift[..., 0, 2] = x0
    shift[..., 1, 2] = y0
    return K - shift


def register_packed_body(refiner, scorer, mesh, diam, cfg: EstimatorCfg, rot_grid, hyp_valid, K_full,
                         buf, hw, iterations: int):
    """register_body on a pack_register_frame buffer: unpack, shift the
    full-frame K's principal point by the packed window offset, register."""
    profiling.mark("prep")
    rgb, depth_raw, mask, x0, y0 = unpack_register_frame(buf, hw)
    return register_body(refiner, scorer, mesh, diam, cfg, rot_grid, hyp_valid,
                         shift_principal_point(K_full, x0, y0), rgb, depth_raw, mask, iterations)


def _register_key(path, cfg: EstimatorCfg, rot_grid, iterations: int, *sizes):
    """What jax.jit keys a register on, besides the inputs' shapes and
    dtypes (which StepGraphs adds): the path, the packed frame's (h, w),
    the iterations and the funnel ((prune_after_iter, prune_keep), or None
    for a full register)."""
    return (path, *sizes, iterations, funnel_of(cfg, iterations, rot_grid.shape[0]))


def register_graph(refiner_net, scorer_net, cfg: EstimatorCfg, mesh, rot_grid, hyp_valid, K,
                   rgb_u8, depth_raw, mask, mesh_diameter, iterations,
                   graphs: StepGraphs | None = None):
    """The unpacked-upload register (K of the frame, rgb u8 (H, W, 3),
    depth f32 (H, W), mask (H, W)) as one captured step (`step_graphs`),
    replayed from `graphs`, an owner's cache: register_body. The step runs
    eagerly at its first call and is captured at its second. Returns fresh
    (order, refined_sorted, scores_sorted, center, n_valid)."""
    iterations = int(iterations)

    def body(rot_grid, hyp_valid, K, rgb_u8, depth_raw, mask, diam):
        profiling.mark("prep")
        rgb = rgb_u8.to(torch.float32) / 255.0
        return register_body(refiner_net, scorer_net, mesh, diam, cfg, rot_grid, hyp_valid, K, rgb,
                             depth_raw, mask, iterations)

    return run_step(graphs, _register_key("register", cfg, rot_grid, iterations),
                    (refiner_net, scorer_net, cfg, mesh), body, rot_grid, hyp_valid, K, rgb_u8,
                    depth_raw, mask, mesh_diameter, eager_first=True)


def register_graph_packed(refiner_net, scorer_net, cfg: EstimatorCfg, mesh, rot_grid, hyp_valid,
                          K, buf, mesh_diameter, hw, iterations,
                          graphs: StepGraphs | None = None):
    """register_packed_body (a pack_register_frame buffer of an (h, w)
    window, K of the full frame) as one captured step, replayed from
    `graphs` (see register_graph)."""
    hw, iterations = tuple(hw), int(iterations)

    def body(rot_grid, hyp_valid, K, buf, diam):
        return register_packed_body(refiner_net, scorer_net, mesh, diam, cfg, rot_grid, hyp_valid, K,
                                    buf, hw, iterations)

    return run_step(graphs, _register_key("register_packed", cfg, rot_grid, iterations, hw),
                    (refiner_net, scorer_net, cfg, mesh), body, rot_grid, hyp_valid, K, buf,
                    mesh_diameter, eager_first=True)


def track_packed_body(refiner_net, cfg: EstimatorCfg, mesh, pose_last, K_full, buf,
                      mesh_diameter, hw, iterations):
    """track_body on a pack_track_frame buffer: unpack, shift the
    full-frame K's principal point by the packed window offset, track."""
    profiling.mark("prep")
    rgb, depth_raw, x0, y0 = unpack_track_frame(buf, hw)
    return track_body(refiner_net, cfg, mesh, pose_last, shift_principal_point(K_full, x0, y0),
                      rgb, depth_raw, mesh_diameter, iterations)


def track_graph(refiner_net, cfg: EstimatorCfg, mesh, pose_last, K, rgb_u8, depth_raw,
                mesh_diameter, iterations, graphs: StepGraphs | None = None):
    """One tracking step from unpacked tensors (K of the window, rgb u8
    (h, w, 3), depth f32 (h, w)) as one captured step (`step_graphs`),
    replayed from `graphs`, an owner's cache; returns the new pose."""
    iterations = int(iterations)

    def body(pose, K, rgb_u8, depth_raw, diam):
        profiling.mark("prep")
        rgb = rgb_u8.to(torch.float32) / 255.0
        return track_body(refiner_net, cfg, mesh, pose, K, rgb, depth_raw, diam, iterations)

    return run_step(graphs, ("track", iterations), (refiner_net, cfg, mesh), body,
                    pose_last, K, rgb_u8, depth_raw, mesh_diameter)


def track_graph_packed(refiner_net, cfg: EstimatorCfg, mesh, pose_last, K_full, buf,
                       mesh_diameter, hw, iterations, graphs: StepGraphs | None = None):
    """track_packed_body as one captured step, replayed from `graphs`, an
    owner's cache (see track_graph)."""
    hw, iterations = tuple(hw), int(iterations)

    def body(pose, K_full, buf, diam):
        return track_packed_body(refiner_net, cfg, mesh, pose, K_full, buf, diam, hw, iterations)

    return run_step(graphs, ("track_packed", hw, iterations), (refiner_net, cfg, mesh), body,
                    pose_last, K_full, buf, mesh_diameter)


class TrackChain:
    """k tracking steps chained on the device over k staged packed frames:
    one `track_graph_packed` step, captured at the first call (a
    `StepGraph`), replayed once a frame with the pose chained device to
    device. No host synchronisation between steps. On the CPU each step
    runs eagerly."""

    def __init__(self, refiner_net, cfg: EstimatorCfg, mesh, K_full, mesh_diameter, hw,
                 iterations):
        self.step_args = (refiner_net, cfg, mesh)
        self.K_full = K_full
        self.diam = mesh_diameter
        self.hw = tuple(hw)
        self.iterations = int(iterations)
        self.graphs = StepGraphs()

    def __call__(self, pose0: torch.Tensor, bufs: torch.Tensor) -> torch.Tensor:
        """pose0 (4, 4), bufs (k, n_bytes) uint8 on the device -> the (k, 4,
        4) trajectory on the device."""
        poses, p = [], pose0
        for buf in bufs:
            p = track_graph_packed(*self.step_args, p, self.K_full, buf, self.diam, self.hw,
                                   self.iterations, graphs=self.graphs)
            poses.append(p)
        return torch.stack(poses)


def track_chain_graph(refiner_net, cfg: EstimatorCfg, mesh, pose0, K_full, bufs, mesh_diameter,
                      hw, iterations):
    """k sequential tracking steps over k pack_track_frame buffers, chained
    on the device; returns the (k, 4, 4) trajectory on the device. `bufs`
    is a (k, n_bytes) uint8 array or tensor: a host array is uploaded once
    (pinned, asynchronous). Each step computes what `track_packed_body`
    computes (see TrackChain)."""
    dev = K_full.device
    if isinstance(bufs, np.ndarray):
        host = torch.from_numpy(np.ascontiguousarray(bufs))
        if dev.type == "cuda":
            host = host.pin_memory()
        bufs = host.to(dev, non_blocking=True)
    return TrackChain(refiner_net, cfg, mesh, K_full, mesh_diameter, hw, iterations)(pose0, bufs)
