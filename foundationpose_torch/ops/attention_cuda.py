"""Wrapper of the fused attention kernel (csrc/attention.cu).

Replaces the Pallas TPU kernel foundationpose_tpu/ops/attention.py
::_mha_kernel (call at _attention_core_pallas). The plain form is bound
by the bytes of its (B, H, L, L) logits; the kernel keeps them on chip
and is bound by reading qkv and writing the output once. bf16 runs both
products on the tensor cores (mma.sync, two passes over the keys so that
the weights are normalized before they are rounded); f32 runs on the
CUDA cores, never in TF32 (see csrc/attention.cu). Reached through
ops/attention.py::attention_core for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import KernelLibrary, check_status

KERNEL = KernelLibrary("attention.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib):
    lib.fp_attention_launch.restype = ctypes.c_int
    lib.fp_attention_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p
    ]


def attention_core_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """qkv (B, L, 3D) bf16 or f32 on a CUDA device -> (B, L, D)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"attention kernel: qkv must be on a CUDA device, got {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"attention kernel: dtype {qkv.dtype} not supported (bf16, f32)")
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"attention kernel: qkv must be (B, L, 3D), got {tuple(qkv.shape)}")
    B, L, threeD = qkv.shape
    D = threeD // 3
    if D % num_heads or not 1 <= D // num_heads <= 128:
        raise ValueError(f"attention kernel: head width D/H = {D}/{num_heads} must be 1..128")
    if B > 65535:
        raise ValueError("attention kernel: batch above 65535")
    qkv = qkv.contiguous()
    out = torch.empty((B, L, D), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or L == 0:
        return out
    lib = KERNEL.lib(_declare)
    KERNEL.launches += 1
    status = lib.fp_attention_launch(
        qkv.data_ptr(), out.data_ptr(), B, L, D, num_heads, _DTYPES[qkv.dtype],
        math.sqrt(D // num_heads), torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    check_status("fp_attention_launch", status)
    return out
