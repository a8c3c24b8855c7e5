"""Wrapper of the fused layer epilogue kernel (csrc/epilogue.cu).

Replaces no TPU kernel (XLA fused these chains into the JAX package's
convolutions): on the card, PyTorch runs the chain after each conv and
linear of RefineNet and ScoreNet (bias add, inference BN, residual add,
ReLU, with the casts between them) as separate passes over the output.
The kernel runs the chain in one pass, bit-equal to the plain ops of
models/layers.py::epilogue, which is the one caller and the plain
version. It writes in place over `y`, the product's fresh output, so the
result keeps the product's strides. The kernel has no backward: an input
that requires a gradient under grad mode raises.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, check_status

KERNEL = KernelLibrary("epilogue.cu", ("--fmad=false",))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIAS, _BN, _RES, _RELU = 1, 2, 4, 8


def _declare(lib):
    lib.fp_epilogue_launch.restype = ctypes.c_int
    lib.fp_epilogue_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]


def rows_of_channels(t: torch.Tensor, axis: int) -> bool:
    """Whether `t` is laid out as rows of contiguous channels, the channels
    being `axis`: 1 of a channels-last 4-D tensor (a conv's output), or -1
    of a contiguous tensor (a linear's)."""
    if axis == 1:
        return t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last)
    return t.ndim >= 1 and t.is_contiguous()


def refusal(y: torch.Tensor, axis: int, residual: torch.Tensor | None = None,
            params=()) -> str | None:
    """Why the kernel cannot take an epilogue over `y` (channels `axis`,
    see `rows_of_channels`) with `residual` and the per-channel tensors
    `params`, or None when it can: y bf16 or f32 on a card as rows of
    channels, the residual alike, the per-channel tensors contiguous f32
    (C,) on y's card, and no gradient wanted (the kernel has no
    backward). models/layers.py::epilogue runs the plain ops where this
    gives a reason; `epilogue_cuda` raises it."""
    tensors = [t for t in (y, residual, *params) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return ("an input requires a gradient, which the kernel's output would not carry; run "
                "the plain ops (models/layers.py::epilogue)")
    if y.device.type != "cuda":
        return f"y must be on a CUDA device, got {y.device}"
    if y.dtype not in _DTYPES:
        return f"dtype {y.dtype} not supported (bf16, f32)"
    if not rows_of_channels(y, axis):
        return f"y must be rows of contiguous channels (axis {axis}), got strides {y.stride()}"
    C = y.shape[axis]
    for p in params:
        if p.device != y.device or p.dtype != torch.float32 or p.shape != (C,) or not p.is_contiguous():
            return (f"per-channel tensors must be contiguous f32 ({C},) on {y.device}, got "
                    f"{p.dtype} {tuple(p.shape)} on {p.device}")
    if residual is not None and (residual.shape != y.shape or residual.dtype != y.dtype
                                 or residual.device != y.device
                                 or not rows_of_channels(residual, axis)):
        return "the residual must have y's shape, dtype, device and layout"
    return None


def epilogue_cuda(y: torch.Tensor, axis: int = -1, bias: torch.Tensor | None = None,
                  bn: tuple[torch.Tensor, ...] | None = None, residual: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """In place over y (bf16 or f32, rows of C channels along `axis`, see
    `rows_of_channels`): bias (C,), bn = (mean, inv, weight, bias) (C,)
    each, residual (y's shape, dtype and layout), ReLU; returns y. The
    per-channel tensors are f32 on y's device; inv is the caller's
    torch.rsqrt(running_var + eps). Raises ValueError with `refusal`'s
    reason on a call the kernel cannot take."""
    if bn is not None and len(bn) != 4:
        raise ValueError("epilogue kernel: bn is (mean, inv, weight, bias)")
    params = ([bias] if bias is not None else []) + list(bn or ())
    reason = refusal(y, axis, residual, params)
    if reason is not None:
        raise ValueError(f"epilogue kernel: {reason}")
    C = y.shape[axis]
    flags = (_BIAS * (bias is not None) | _BN * (bn is not None) | _RES * (residual is not None)
             | _RELU * bool(relu))
    if flags == 0 or y.numel() == 0:
        return y
    vec = 16 // y.element_size()
    if C % vec or any(t.data_ptr() % 16 for t in (y, residual) if t is not None):
        vec = 1
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    mean, inv, weight, shift = bn if bn is not None else (None,) * 4
    lib = KERNEL.lib(_declare)
    KERNEL.launches += 1
    status = lib.fp_epilogue_launch(
        y.data_ptr(), ptr(residual), ptr(bias), ptr(mean), ptr(inv), ptr(weight), ptr(shift),
        y.numel() // C, C, flags, _DTYPES[y.dtype], vec, torch.cuda.current_stream(y.device).cuda_stream,
    )
    check_status("fp_epilogue_launch", status)
    return y
