"""Multi-head self-attention core on packed qkv.

Port of foundationpose_tpu/ops/attention.py. `attention_core` is the one
entry point: a CUDA tensor runs the hand-written kernel of
ops/attention_cuda.py (bf16 or f32), a CPU tensor the plain version
`attention_core_plain`, which mirrors `_attention_core_xla`; any other
device raises. Semantics: torch nn.MultiheadAttention's core with
batch_first. Gradients flow through `_AttentionCore`, the counterpart of
the JAX package's `custom_vjp`: the backward recomputes the plain core.
"""
from __future__ import annotations

import math

import torch

from .. import torch_config  # noqa: F401


def attention_core_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """qkv (B, L, 3D) -> (B, L, D) in qkv's dtype.

    Logits and softmax in f32 (the products of bf16 inputs are exact in
    f32, as with preferred_element_type=f32), weights cast to the input
    dtype before the product with V, f32 sums."""
    B, L, threeD = qkv.shape
    D = threeD // 3
    dh = D // num_heads
    q, k, v = torch.split(qkv, D, dim=-1)

    def heads(t):
        return t.reshape(B, L, num_heads, dh).transpose(1, 2).to(torch.float32)

    q, k, v = heads(q), heads(k), heads(v)
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
    attn = torch.softmax(logits, dim=-1).to(qkv.dtype).to(torch.float32)
    out = torch.matmul(attn, v)
    return out.transpose(1, 2).reshape(B, L, D).to(qkv.dtype)


def _forward(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attention_core_plain(qkv, num_heads)
    if qkv.device.type == "cuda":
        from .attention_cuda import attention_core_cuda

        return attention_core_cuda(qkv, num_heads)
    raise RuntimeError(f"attention_core: no kernel for device {qkv.device}")


class _AttentionCore(torch.autograd.Function):
    """foundationpose_tpu/ops/attention.py::attention_core's custom_vjp.

    The forward is the kernel on a CUDA tensor and the plain core on a
    CPU tensor (autograd runs it with gradients off); it saves qkv. The
    backward casts the output's cotangent to qkv's dtype and
    differentiates `attention_core_plain` at the saved qkv, as
    `_attention_bwd` differentiates `_attention_core_xla`: a recompute in
    plain PyTorch on both devices, since the JAX package's backward is no
    Pallas kernel either."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _forward(qkv, num_heads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            out = attention_core_plain(x, ctx.num_heads)
            (grad,) = torch.autograd.grad(out, x, g.to(qkv.dtype))
        return grad, None


def attention_core(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention core on packed qkv (B, L, 3D) -> (B, L, D);
    differentiable in qkv on every device (see `_AttentionCore`)."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _AttentionCore.apply(qkv, num_heads)
    return _forward(qkv, num_heads)
