"""Dense segment-adds of the hash-grid backward: K3 and K4.

Port of the two entry points of foundationpose_tpu/ops/pallas_scatter.py
that the hash-grid backward reaches:

* `segment_add_planes` (K3; `sorted_segment_add_planes`): the dense
  (table_size, C) f32 sum of an (index, C-plane) update stream;
* `factored_segment_add` (K4): the dense (T, C) sum of the outer products
  bf16(w[q]) * g[c] of (point, level) entries, each product added into
  the row of corner q, the entry's base row shifted within its level by
  the level's shift q (the "oct" hash grid's corner rows). The JAX kernel
  adds them into the base row of a (T, nw*C) block that its caller then
  rolls back per level by those shifts; the plain version below does just
  that, the CUDA kernel adds straight into the shifted rows.

K3 drops indices outside [0, table_size), K4 base rows outside their
entry's level; the order of the updates does not matter. CUDA tensors
run the hand-written kernels of ops/segment_add_cuda.py, CPU tensors the
plain versions below (an f32 `index_add_`); any other device raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import torch_config  # noqa: F401


def _index_add_dropping(idx: torch.Tensor, upd: torch.Tensor, table_size: int) -> torch.Tensor:
    """(M,) indices + (M, D) f32 rows -> (table_size, D); out-of-range
    indices land in a spare row that is cut off."""
    keep = (idx >= 0) & (idx < table_size)
    idx = torch.where(keep, idx, torch.full_like(idx, table_size))
    out = torch.zeros((table_size + 1, upd.shape[1]), dtype=torch.float32, device=upd.device)
    out.index_add_(0, idx, upd)
    return out[:table_size]


def segment_add_planes_plain(idx: torch.Tensor, upd_planes: torch.Tensor, table_size: int) -> torch.Tensor:
    """Plain K3: idx (M,), upd_planes (C, M) f32 -> (table_size, C) f32."""
    return _index_add_dropping(idx.reshape(-1), upd_planes.to(torch.float32).T, table_size)


def check_levels(levels, L: int, nw: int):
    """K4's level constants (offsets (L,), sizes (L,), shifts (L, nw)) as
    int64 numpy arrays, and the table size T they span. The levels tile
    [0, T) in order, T < 2^31, and each shift lies in [0, its level's size)."""
    offsets, sizes, shifts = (np.array(a, dtype=np.int64) for a in levels)
    if offsets.shape != (L,) or sizes.shape != (L,) or shifts.shape != (L, nw):
        raise ValueError(f"K4: levels must be offsets ({L},), sizes ({L},) and shifts ({L}, {nw}), got "
                         f"{offsets.shape}, {sizes.shape}, {shifts.shape}")
    if (sizes < 1).any() or offsets[0] != 0 or (offsets[1:] != offsets[:-1] + sizes[:-1]).any():
        raise ValueError("K4: the levels must tile [0, table_size) in order")
    if ((shifts < 0) | (shifts >= sizes[:, None])).any():
        raise ValueError("K4: each shift must lie in [0, its level's size)")
    T = int(offsets[-1] + sizes[-1])
    if T >= 2**31:
        raise ValueError(f"K4: table_size {T} not below 2^31")
    return offsets, sizes, shifts, T


def _factored_rows_plain(idx_lv, w_planes, g_planes, table_size):
    """idx_lv (L, N), w_planes (nw, L, N), g_planes (C, L, N) -> (table_size,
    nw*C) f32, row q*C + c of an update being bf16_rne(w[q]) * g[c] in f32
    (the JAX fallback's rounding), added at its base row."""
    nw = w_planes.shape[0]
    C = g_planes.shape[0]
    w16 = w_planes.to(torch.bfloat16).to(torch.float32)
    upd = (w16[:, None] * g_planes.to(torch.float32)[None]).reshape(nw * C, -1)
    return _index_add_dropping(idx_lv.reshape(-1), upd.T, table_size)


def _fold_shifted_rows(dq, C, offsets, sizes, shifts):
    """(T, nw*C) base-row sums -> (T, C): column block q of each level rolled
    down its level by the level's shift q, and the blocks added."""
    segs = []
    for lv in range(len(offsets)):
        dql = dq[int(offsets[lv]) : int(offsets[lv] + sizes[lv])]
        acc = torch.roll(dql[:, 0:C], int(shifts[lv, 0]), dims=0)
        for q in range(1, shifts.shape[1]):
            acc = acc + torch.roll(dql[:, q * C : (q + 1) * C], int(shifts[lv, q]), dims=0)
        segs.append(acc)
    return torch.cat(segs)


def factored_segment_add_plain(idx: torch.Tensor, w_planes, g: torch.Tensor, levels) -> torch.Tensor:
    """Plain K4: idx (N, L) base rows, w_planes nw planes (N, L), g (N, L, C)
    -> (T, C) f32: the JAX package's (T, nw*C) base-row sums, rolled back
    per level by the shifts. A base row outside its level is dropped."""
    offsets, sizes, shifts, T = check_levels(levels, idx.shape[1], len(w_planes))
    lo = torch.as_tensor(offsets, device=idx.device)
    idx = torch.where((idx >= lo) & (idx < lo + torch.as_tensor(sizes, device=idx.device)), idx, -1)
    dq = _factored_rows_plain(idx.T, torch.stack([wq.T for wq in w_planes]), g.permute(2, 1, 0), T)
    return _fold_shifted_rows(dq, g.shape[2], offsets, sizes, shifts)


def segment_add_planes(idx: torch.Tensor, upd_planes: torch.Tensor, table_size: int) -> torch.Tensor:
    """K3: dense (table_size, C) f32 sum of updates grouped by index."""
    if upd_planes.device.type == "cpu":
        return segment_add_planes_plain(idx, upd_planes, table_size)
    if upd_planes.device.type == "cuda":
        from .segment_add_cuda import segment_add_planes_cuda

        return segment_add_planes_cuda(idx, upd_planes, table_size)
    raise RuntimeError(f"segment_add_planes: no kernel for device {upd_planes.device}")


def factored_segment_add(idx: torch.Tensor, w_planes, g: torch.Tensor, levels) -> torch.Tensor:
    """K4: dense (T, C) f32 sum of bf16(w[q]) * g[c] into the shifted rows
    of corner q; idx (N, L) base rows, w_planes a sequence of nw (N, L)
    planes, g (N, L, C), levels (offsets, sizes, shifts (L, nw))."""
    if g.device.type == "cpu":
        return factored_segment_add_plain(idx, w_planes, g, levels)
    if g.device.type == "cuda":
        from .segment_add_cuda import factored_segment_add_cuda

        return factored_segment_add_cuda(idx, w_planes, g, levels)
    raise RuntimeError(f"factored_segment_add: no kernel for device {g.device}")
