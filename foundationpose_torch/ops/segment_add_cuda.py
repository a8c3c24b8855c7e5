"""Wrappers of the segment-add kernels K3 and K4 (csrc/segment_add.cu).

K3 replaces the Pallas TPU kernel foundationpose_tpu/ops/pallas_scatter.py
::_seg_add_kernel (reached from sorted_segment_add_planes), K4 replaces
::_seg_add_factored_kernel (reached from factored_segment_add). Neither
sorts. K3 merges in registers the runs of one row that consecutive points
send (the same row recurs every 128 updates of the hash-grid backward's
stream) and adds each run with one vector reduction; K4's warps add their
rows' columns from neighbouring lanes (see the header of
csrc/segment_add.cu). Reached through ops/segment_add.py for
CUDA tensors. The two kernels share one source and one library, and each
wrapper counts its own launches.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, check_status

K3 = KernelLibrary("segment_add.cu")
K4 = KernelLibrary("segment_add.cu")
_P = ctypes.c_void_p
_I = ctypes.c_int

K3_SPAN = 1024  # updates a warp walks: the span within which K3 merges runs of a row


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
    lib.fp_factored_segment_add_launch.argtypes = [_P] * 4 + [ctypes.c_longlong] + [_I] * 3 + [_P]


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


def factored_segment_add_cuda(
    idx_lv: torch.Tensor, w_planes: torch.Tensor, g_planes: torch.Tensor, table_size: int
) -> torch.Tensor:
    """K4: idx_lv (L, N), w_planes (nw, L, N) f32, g_planes (C, L, N) f32
    on a CUDA device -> (table_size, nw*C) f32."""
    dev = g_planes.device
    if dev.type != "cuda":
        raise ValueError(f"K4: tensors must be on a CUDA device, got {dev}")
    _check("idx_lv", idx_lv, dev)
    _check("w_planes", w_planes, dev)
    if w_planes.dtype != torch.float32 or g_planes.dtype != torch.float32:
        raise ValueError("K4: w_planes and g_planes must be float32")
    if idx_lv.ndim != 2 or w_planes.ndim != 3 or g_planes.ndim != 3:
        raise ValueError("K4: expected idx_lv (L, N), w_planes (nw, L, N), g_planes (C, L, N)")
    nw, C = w_planes.shape[0], g_planes.shape[0]
    if w_planes.shape[1:] != idx_lv.shape or g_planes.shape[1:] != idx_lv.shape:
        raise ValueError("K4: w_planes and g_planes must match idx_lv's (L, N)")
    if not (1 <= nw <= 8 and 1 <= C <= 8 and nw * C <= 32):
        raise ValueError(f"K4: nw = {nw} and C = {C} must lie in 1..8 with nw * C <= 32")
    idx = _indices(idx_lv, table_size)
    w = w_planes.contiguous()
    g = g_planes.contiguous()
    out = torch.zeros((table_size, nw * C), dtype=torch.float32, device=dev)
    LN = idx.numel()
    if LN == 0 or table_size == 0:
        return out
    lib = K4.lib(_declare)
    K4.launches += 1
    status = lib.fp_factored_segment_add_launch(
        idx.data_ptr(), w.data_ptr(), g.data_ptr(), out.data_ptr(), LN, nw, C, table_size,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status("fp_factored_segment_add_launch", status)
    return out
