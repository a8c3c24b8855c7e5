"""Wrappers of the segment-add kernels K3 and K4 (csrc/segment_add.cu).

K3 replaces the Pallas TPU kernel foundationpose_tpu/ops/pallas_scatter.py
::_seg_add_kernel (reached from sorted_segment_add_planes), K4 replaces
::_seg_add_factored_kernel (reached from factored_segment_add). Neither
sorts. K3 merges in registers the runs of one row that consecutive points
send (the same row recurs every 128 updates of the hash-grid backward's
stream) and adds each run with one vector reduction. K4 writes the "oct"
hash grid's folded (T, C) table gradient itself: each (point, level)
entry's products go into its eight corner rows, the base row shifted
within the level by the level's corner shifts (passed by value), with
runs of one base row merged in registers the same way (see the header
of csrc/segment_add.cu). Reached through ops/segment_add.py for CUDA
tensors. The two kernels share one source and one library, and each
wrapper counts its own launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import KernelLibrary, check_status
from .segment_add import check_levels

K3 = KernelLibrary("segment_add.cu")
K4 = KernelLibrary("segment_add.cu")
_P = ctypes.c_void_p
_I = ctypes.c_int

K3_SPAN = 1024  # updates a warp walks: the span within which K3 merges runs of a row
K4_RUN = 8  # points of one level a thread walks: the span within which K4 merges runs of a base row


def _k3_geometry(C: int) -> tuple[int, int]:
    """K3's schedule for C channels: (S updates a warp walks, W channels a
    pass). Each reduction adds W floats of one table row, aligned: W = 4
    where 4 divides C, else 2 where 2 does, else 1; C / W passes read the
    indices again. S is a multiple of the 128 updates a warp loads a step."""
    if not 1 <= C <= 32:
        raise ValueError(f"K3: C = {C} channels, 1 to 32 supported")
    W = 4 if C % 4 == 0 else 2 if C % 2 == 0 else 1
    return K3_SPAN, W


def _declare(lib):
    lib.fp_segment_add_planes_launch.restype = ctypes.c_int
    lib.fp_segment_add_planes_launch.argtypes = [_P] * 3 + [ctypes.c_longlong, _I, _I, ctypes.c_longlong, _I, _P]
    lib.fp_factored_segment_add_launch.restype = ctypes.c_int
    lib.fp_factored_segment_add_launch.argtypes = [_P] * 4 + [ctypes.c_longlong] + [_I] * 3 + [_P, _I, _P]


def _check(name, t, dev):
    if t.device != dev:
        raise ValueError(f"segment-add kernel: {name} must be on {dev}, got {t.device}")


def _indices(idx: torch.Tensor, table_size: int) -> torch.Tensor:
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"segment-add kernel: indices must be int32 or int64, got {idx.dtype}")
    if not 0 <= table_size < 2**31:
        raise ValueError(f"segment-add kernel: table_size {table_size} outside [0, 2^31)")
    if idx.dtype == torch.int64:  # out-of-range int64 values must stay out of range
        idx = idx.clamp(-1, table_size)
    return idx.to(torch.int32).contiguous().reshape(-1)


def segment_add_planes_cuda(idx: torch.Tensor, upd_planes: torch.Tensor, table_size: int) -> torch.Tensor:
    """K3: idx (M,), upd_planes (C, M) f32 on a CUDA device -> (table_size, C) f32."""
    dev = upd_planes.device
    if dev.type != "cuda":
        raise ValueError(f"K3: tensors must be on a CUDA device, got {dev}")
    _check("idx", idx, dev)
    if upd_planes.dtype != torch.float32 or upd_planes.ndim != 2:
        raise ValueError("K3: upd_planes must be (C, M) float32")
    C, M = upd_planes.shape
    if C > 32:
        raise ValueError(f"K3: at most 32 channels, got {C}")
    if idx.numel() != M:
        raise ValueError(f"K3: {idx.numel()} indices for {M} updates")
    idx = _indices(idx, table_size)
    upd = upd_planes.contiguous()
    out = torch.zeros((table_size, C), dtype=torch.float32, device=dev)
    if M == 0 or C == 0 or table_size == 0:
        return out
    S, W = _k3_geometry(C)
    lib = K3.lib(_declare)
    K3.launches += 1
    status = lib.fp_segment_add_planes_launch(
        idx.data_ptr(), upd.data_ptr(), out.data_ptr(), M, C, table_size, S, W,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status("fp_segment_add_planes_launch", status)
    return out


def factored_segment_add_cuda(idx: torch.Tensor, w_planes, g: torch.Tensor, levels) -> torch.Tensor:
    """K4: idx (N, L) base rows, w_planes nw (N, L) f32 planes, g (N, L, C)
    f32 on a CUDA device, levels (offsets, sizes, shifts (L, nw)) -> the
    (T, C) f32 sums of bf16(w[q]) * g[c] in the shifted rows of corner q."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"K4: tensors must be on a CUDA device, got {dev}")
    _check("idx", idx, dev)
    if idx.ndim != 2 or g.ndim != 3 or g.shape[:2] != idx.shape:
        raise ValueError("K4: expected idx (N, L) and g (N, L, C)")
    N, L, C = g.shape
    nw = len(w_planes)
    for wq in w_planes:
        _check("w_planes", wq, dev)
        if wq.dtype != torch.float32 or wq.shape != idx.shape:
            raise ValueError("K4: each weight plane must be float32 of idx's (N, L)")
    if g.dtype != torch.float32:
        raise ValueError("K4: g must be float32")
    if not (1 <= nw <= 8 and 1 <= C <= 8 and L <= 32):
        raise ValueError(f"K4: nw = {nw} and C = {C} must lie in 1..8, L = {L} at most 32")
    offsets, sizes, shifts, T = check_levels(levels, L, nw)
    idx = _indices(idx, T)
    w = [wq.contiguous() for wq in w_planes]
    g = g.contiguous()
    out = torch.zeros((T, C), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    consts = np.ascontiguousarray(np.concatenate([offsets[:, None], sizes[:, None], shifts], axis=1), np.int32)
    ptrs = (ctypes.c_void_p * nw)(*[wq.data_ptr() for wq in w])
    lib = K4.lib(_declare)
    K4.launches += 1
    status = lib.fp_factored_segment_add_launch(
        idx.data_ptr(), ptrs, g.data_ptr(), out.data_ptr(), N, L, nw, C,
        consts.ctypes.data, K4_RUN, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status("fp_factored_segment_add_launch", status)
    return out
