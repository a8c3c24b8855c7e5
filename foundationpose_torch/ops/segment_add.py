"""Dense segment-adds of the hash-grid backward: K3 and K4.

Port of the two entry points of foundationpose_tpu/ops/pallas_scatter.py
that the hash-grid backward reaches:

* `segment_add_planes` (K3; `sorted_segment_add_planes`): the dense
  (table_size, C) f32 sum of an (index, C-plane) update stream;
* `factored_segment_add` (K4): the dense (table_size, nw*C) sum of the
  outer products bf16(w[q]) * g[c], indices given per level.

Indices outside [0, table_size) are dropped; the order of the updates
does not matter. CUDA tensors run the hand-written kernels of
ops/segment_add_cuda.py, CPU tensors the plain versions below (an f32
`index_add_`); any other device raises.
"""
from __future__ import annotations

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


def factored_segment_add_plain(
    idx_lv: torch.Tensor, w_planes: torch.Tensor, g_planes: torch.Tensor, table_size: int
) -> torch.Tensor:
    """Plain K4: idx_lv (L, N), w_planes (nw, L, N), g_planes (C, L, N)
    -> (table_size, nw*C) f32, row q*C + c of an update being
    bf16_rne(w[q]) * g[c] in f32 (the JAX fallback's rounding)."""
    nw = w_planes.shape[0]
    C = g_planes.shape[0]
    w16 = w_planes.to(torch.bfloat16).to(torch.float32)
    upd = (w16[:, None] * g_planes.to(torch.float32)[None]).reshape(nw * C, -1)
    return _index_add_dropping(idx_lv.reshape(-1), upd.T, table_size)


def segment_add_planes(idx: torch.Tensor, upd_planes: torch.Tensor, table_size: int) -> torch.Tensor:
    """K3: dense (table_size, C) f32 sum of updates grouped by index."""
    if upd_planes.device.type == "cpu":
        return segment_add_planes_plain(idx, upd_planes, table_size)
    if upd_planes.device.type == "cuda":
        from .segment_add_cuda import segment_add_planes_cuda

        return segment_add_planes_cuda(idx, upd_planes, table_size)
    raise RuntimeError(f"segment_add_planes: no kernel for device {upd_planes.device}")


def factored_segment_add(
    idx_lv: torch.Tensor, w_planes: torch.Tensor, g_planes: torch.Tensor, table_size: int
) -> torch.Tensor:
    """K4: dense (table_size, nw*C) f32 sum of bf16(w[q]) * g[c]."""
    if g_planes.device.type == "cpu":
        return factored_segment_add_plain(idx_lv, w_planes, g_planes, table_size)
    if g_planes.device.type == "cuda":
        from .segment_add_cuda import factored_segment_add_cuda

        return factored_segment_add_cuda(idx_lv, w_planes, g_planes, table_size)
    raise RuntimeError(f"factored_segment_add: no kernel for device {g_planes.device}")
