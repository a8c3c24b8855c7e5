"""Network building blocks as nn.Modules.

Port of foundationpose_tpu/models/layers.py. Parameters stay f32 and
each layer computes in the `dtype` it is called with (bf16 on the main
path), with f32 bias adds and normalization statistics, as the
reference does. Submodule and parameter names follow the reference torch
modules (learning/models/network_modules.py), so `state_dict()` keys are
the names models/convert.py of the JAX package reads. What follows each
conv's and linear's product (bias, BN, residual, ReLU) is `epilogue`:
one fused kernel on a card, the plain ops elsewhere, bit-equal.

Images are NCHW inside the trunks (channels-last in memory on the main
path); token tensors are (B, L, D).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import torch_config  # noqa: F401
from ..ops.attention import attention_core
from ..ops import epilogue_cuda
from ..utils import profiling

BN_EPS = 1e-5
LN_EPS = 1e-5


def _add_bias(y: torch.Tensor, bias: torch.Tensor | None, shape, dtype) -> torch.Tensor:
    if bias is not None:
        y = y.to(torch.float32) + bias.reshape(shape)
    return y.to(dtype)


def epilogue(y, dtype, bias=None, bn=None, residual=None, relu=False, axis=-1):
    """The chain after a conv's or linear's product `y` (in `dtype`), its
    channels `axis` (1 for a conv's NCHW output, -1 for a linear's): the
    bias added in f32 and rounded to dtype, the inference BN `bn` (a
    BatchNorm2d, over dim 1) in f32 and rounded, `residual` added, ReLU.

    On a card, with no gradient wanted and rows of contiguous channels
    (a channels-last conv output, a linear output), one kernel
    (ops/epilogue_cuda.py) runs the chain bit-equal to the plain ops and
    writes it over y, the product's fresh output; every other call (the
    CPU, training under autograd, other layouts: where
    `epilogue_cuda.refusal` gives a reason) runs the plain ops. While the
    recorder records (utils/profiling.py), its counters `epilogue.fused`
    and `epilogue.plain` count the calls of each path."""
    params = [] if bias is None else [bias]
    if bn is not None:
        params += [bn.running_mean, bn.running_var, bn.weight, bn.bias]
    fused = epilogue_cuda.refusal(y, axis, residual, params) is None
    if profiling.recording():
        profiling.count("epilogue.fused" if fused else "epilogue.plain")
    if fused:
        stats = None
        if bn is not None:
            inv = torch.rsqrt(bn.running_var + BN_EPS)
            stats = (bn.running_mean, inv, bn.weight, bn.bias)
        return epilogue_cuda.epilogue_cuda(y, axis, bias, stats, residual, relu)
    y = _add_bias(y, bias, (1, -1, 1, 1) if axis == 1 else (-1,), dtype)
    if bn is not None:
        y = bn(y)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


class Conv2d(nn.Conv2d):
    """Conv with padding (k-1)//2, computed in the call's dtype, then
    `epilogue` (bias, optional BN, residual and ReLU).

    `pad_to`, the caller's word that x's channels past the weight's are
    zeros (networks.pad_pairs), pads the weight's copy in `dtype` with
    zeros to that many input channels, so the sums are the same and the
    parameter keeps its shape; under autograd its gradient is the padded
    one's slice. While the recorder records, counter `conv.channel_pad`
    counts such calls. Without it, a channel count other than the
    weight's raises."""

    def __init__(self, cin, cout, k, stride=1, bias=True):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=bias)

    def forward(self, x, dtype=torch.float32, bn=None, residual=None, relu=False, pad_to=None):
        w = self.weight.to(dtype)
        if pad_to is not None and pad_to > self.in_channels:
            w = F.pad(w, (0, 0, 0, 0, 0, pad_to - self.in_channels))
            if profiling.recording():
                profiling.count("conv.channel_pad")
        y = F.conv2d(x.to(dtype), w, None, self.stride, self.padding)
        return epilogue(y, dtype, self.bias, bn, residual, relu, axis=1)


class Linear(nn.Linear):
    def forward(self, x, dtype=torch.float32, residual=None, relu=False):
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return epilogue(y, dtype, self.bias, residual=residual, relu=relu)


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

    def forward(self, x, dtype=torch.float32, pad_to=None):
        """`pad_to`: the conv's (Conv2d.forward)."""
        bn = self.net[1] if isinstance(self.net[1], BatchNorm2d) else None
        return self.net[0](x, dtype, bn=bn, relu=True, pad_to=pad_to)


class ResnetBasicBlock(nn.Module):
    """Stride 1, biased convs, no downsample."""

    def __init__(self, c, use_bn):
        super().__init__()
        self.conv1 = Conv2d(c, c, 3)
        self.conv2 = Conv2d(c, c, 3)
        self.bn1 = BatchNorm2d(c) if use_bn else None
        self.bn2 = BatchNorm2d(c) if use_bn else None

    def forward(self, x, dtype=torch.float32):
        out = self.conv1(x, dtype, bn=self.bn1, relu=True)
        return self.conv2(out, dtype, bn=self.bn2, residual=x.to(dtype), relu=True)


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

    def forward(self, x, dtype=torch.float32, residual=None):
        """`residual` is added to the output in out_proj's epilogue."""
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype))
        qkv = epilogue(qkv, dtype, self.in_proj_bias)
        out = attention_core(qkv, self.num_heads).to(dtype)
        return self.out_proj(out, dtype, residual=residual)


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
        x = self.norm1(self.self_attn(x, dtype, residual=x))
        ff = self.linear1(x, dtype, relu=True)
        return self.norm2(self.linear2(ff, dtype, residual=x))


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
