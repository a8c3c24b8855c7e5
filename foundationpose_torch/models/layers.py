"""Network building blocks as nn.Modules.

Port of foundationpose_tpu/models/layers.py. Parameters stay f32 and
each layer computes in the `dtype` it is called with (bf16 on the main
path), with f32 bias adds and normalization statistics, as the
reference does. Submodule and parameter names follow the reference torch
modules (learning/models/network_modules.py), so `state_dict()` keys are
the names models/convert.py of the JAX package reads.

Images are NCHW inside the trunks; token tensors are (B, L, D).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import torch_config  # noqa: F401
from ..ops.attention import attention_core

BN_EPS = 1e-5
LN_EPS = 1e-5


def _add_bias(y: torch.Tensor, bias: torch.Tensor | None, shape, dtype) -> torch.Tensor:
    if bias is not None:
        y = y.to(torch.float32) + bias.reshape(shape)
    return y.to(dtype)


class Conv2d(nn.Conv2d):
    """Conv with padding (k-1)//2, computed in the call's dtype."""

    def __init__(self, cin, cout, k, stride=1, bias=True):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=bias)

    def forward(self, x, dtype=torch.float32):
        y = F.conv2d(x.to(dtype), self.weight.to(dtype), None, self.stride, self.padding)
        return _add_bias(y, self.bias, (1, -1, 1, 1), dtype)


class Linear(nn.Linear):
    def forward(self, x, dtype=torch.float32):
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return _add_bias(y, self.bias, (-1,), dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """Inference-mode BN over channels (dim 1), in f32."""

    def forward(self, x, dtype=None):
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var + BN_EPS).reshape(shape)
        y = (x.to(torch.float32) - self.running_mean.reshape(shape)) * inv
        return (y * self.weight.reshape(shape) + self.bias.reshape(shape)).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    def __init__(self, d):
        super().__init__(d, eps=LN_EPS)

    def forward(self, x, dtype=None):
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + LN_EPS)
        return (y * self.weight + self.bias).to(x.dtype)


class ReLU(nn.Module):
    def forward(self, x, dtype=None):
        return F.relu(x)


class ConvBNReLU(nn.Module):
    """Reference ConvBNReLU: `net` = [conv, bn, relu] (bn left out without
    use_bn)."""

    def __init__(self, cin, cout, k, stride, use_bn):
        super().__init__()
        mods = [Conv2d(cin, cout, k, stride)]
        if use_bn:
            mods.append(BatchNorm2d(cout))
        mods.append(ReLU())
        self.net = nn.ModuleList(mods)

    def forward(self, x, dtype=torch.float32):
        for m in self.net:
            x = m(x, dtype)
        return x


class ResnetBasicBlock(nn.Module):
    """Stride 1, biased convs, no downsample."""

    def __init__(self, c, use_bn):
        super().__init__()
        self.conv1 = Conv2d(c, c, 3)
        self.conv2 = Conv2d(c, c, 3)
        self.bn1 = BatchNorm2d(c) if use_bn else None
        self.bn2 = BatchNorm2d(c) if use_bn else None

    def forward(self, x, dtype=torch.float32):
        out = self.conv1(x, dtype)
        if self.bn1 is not None:
            out = self.bn1(out)
        out = F.relu(out)
        out = self.conv2(out, dtype)
        if self.bn2 is not None:
            out = self.bn2(out)
        return F.relu(out + x.to(dtype))


def positional_embedding(d_model: int, max_len: int, device=None) -> torch.Tensor:
    """Sinusoidal table (1, max_len, d_model)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )[None]
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe[None]


class MultiheadAttention(nn.Module):
    """Self-attention with torch nn.MultiheadAttention's parameter names
    (batch_first); the core is ops/attention.py::attention_core."""

    def __init__(self, d, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d)

    def forward(self, x, dtype=torch.float32):
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype))
        qkv = _add_bias(qkv, self.in_proj_bias, (-1,), dtype)
        out = attention_core(qkv, self.num_heads).to(dtype)
        return self.out_proj(out, dtype)


class TransformerEncoderLayer(nn.Module):
    """nn.TransformerEncoderLayer defaults: post-norm, relu feed-forward,
    dropout inactive at inference."""

    def __init__(self, d, num_heads, ff):
        super().__init__()
        self.self_attn = MultiheadAttention(d, num_heads)
        self.linear1 = Linear(d, ff)
        self.linear2 = Linear(ff, d)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)

    def forward(self, x, dtype=torch.float32):
        y = self.self_attn(x, dtype)
        x = self.norm1(x + y)
        ff = self.linear2(F.relu(self.linear1(x, dtype)), dtype)
        return self.norm2(x + ff)


# ----------------------------------------------------------------- init


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(
            (torch.rand(t.shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound
        )


def init_weights_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every parameter from `gen` with the reference's distributions:
    fan-in uniform for conv/linear weights and biases, xavier-uniform
    in-projection with zero bias, identity norms and BN statistics."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            fan_in = m.weight[0].numel()
            _uniform_(m.weight, math.sqrt(1.0 / fan_in) * math.sqrt(3.0), gen)
            if m.bias is not None:
                _uniform_(m.bias, 1.0 / math.sqrt(fan_in), gen)
        elif isinstance(m, MultiheadAttention):
            d = m.in_proj_weight.shape[1]
            _uniform_(m.in_proj_weight, math.sqrt(6.0 / (d + 3 * d)), gen)
            with torch.no_grad():
                m.in_proj_bias.zero_()
        elif isinstance(m, (BatchNorm2d, LayerNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, BatchNorm2d):
                m.reset_running_stats()
    return module
