"""RefineNet and ScoreNetMultiPair of the reference as plain f32 functions
of a state dict.

From NVlabs/FoundationPose learning/models/refine_network.py,
score_network.py and network_modules.py: a shared trunk (7x7 and 3x3
stride-2 ConvBNReLU, two residual blocks) encodes the rendered (A) and
observed (B) crops, the concatenated features pass two residual blocks,
a stride-2 ConvBNReLU to 8 x base_width channels and two more blocks; the
20x20 map becomes 400 row-major tokens plus sinusoidal positions. The
refiner regresses translation and rotation through one post-norm
transformer encoder layer each (feed-forward 512) and a linear head,
averaged over tokens; the scorer self-attends each pair, mean-pools, and
attends across the hypotheses of one group before a linear logit. BN is
inference-mode. TF32 is off (set by the caller: `plain_numerics`).

`quant="fp8"` rounds the inputs of every convolution, linear layer and
attention product to float8 e4m3 with one scale per tensor, and computes
in f32: the control that a program in a lower precision than the
configuration's bfloat16 must fail. Gradients pass the rounding
unchanged.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-5
FF = 512  # the reference's dim_feedforward


def plain_numerics():
    """f32 products in f32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def plain_scope():
    """plain_numerics inside the block; the flags as they were after it."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    plain_numerics()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def _q(x, quant):
    return _Fp8.apply(x) if quant == "fp8" else x


def conv(p, name, x, stride, quant):
    w = p[name + ".weight"]
    k = w.shape[-1]
    y = F.conv2d(_q(x, quant), _q(w, quant), None, stride, (k - 1) // 2)
    return y + p[name + ".bias"].reshape(1, -1, 1, 1)


def bn(p, name, x):
    inv = torch.rsqrt(p[name + ".running_var"] + BN_EPS).reshape(1, -1, 1, 1)
    y = (x - p[name + ".running_mean"].reshape(1, -1, 1, 1)) * inv
    return y * p[name + ".weight"].reshape(1, -1, 1, 1) + p[name + ".bias"].reshape(1, -1, 1, 1)


def linear(p, name, x, quant):
    return _q(x, quant) @ _q(p[name + ".weight"], quant).T + p[name + ".bias"]


def layer_norm(p, name, x):
    m = x.mean(-1, keepdim=True)
    var = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(var + LN_EPS) * p[name + ".weight"] + p[name + ".bias"]


def conv_bn_relu(p, name, x, stride, quant):
    return torch.relu(bn(p, name + ".net.1", conv(p, name + ".net.0", x, stride, quant)))


def res_block(p, name, x, quant):
    y = torch.relu(bn(p, name + ".bn1", conv(p, name + ".conv1", x, 1, quant)))
    y = bn(p, name + ".bn2", conv(p, name + ".conv2", y, 1, quant))
    return torch.relu(y + x)


def attention(p, name, x, heads, quant):
    """nn.MultiheadAttention (batch_first) self-attention of x (B, L, D)."""
    B, L, D = x.shape
    qkv = _q(x, quant) @ _q(p[name + ".in_proj_weight"], quant).T + p[name + ".in_proj_bias"]
    q, k, v = (t.reshape(B, L, heads, D // heads).transpose(1, 2) for t in qkv.split(D, -1))
    s = _q(q, quant) @ _q(k, quant).transpose(-1, -2) / math.sqrt(D // heads)
    o = _q(torch.softmax(s, -1), quant) @ _q(v, quant)
    return linear(p, name + ".out_proj", o.transpose(1, 2).reshape(B, L, D), quant)


def encoder_layer(p, name, x, heads, quant):
    x = layer_norm(p, name + ".norm1", x + attention(p, name + ".self_attn", x, heads, quant))
    ff = linear(p, name + ".linear2", torch.relu(linear(p, name + ".linear1", x, quant)), quant)
    return layer_norm(p, name + ".norm2", x + ff)


def positions(d, n, device):
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros((n, d), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def tokens(p, enc_a, enc_ab, A, B, quant):
    """(N, res, res, c) crops -> (N, L, D) tokens with positions."""
    n = A.shape[0]
    x = torch.cat([A, B]).permute(0, 3, 1, 2)
    x = conv_bn_relu(p, enc_a + ".0", x, 2, quant)
    x = conv_bn_relu(p, enc_a + ".1", x, 2, quant)
    x = res_block(p, enc_a + ".2", x, quant)
    x = res_block(p, enc_a + ".3", x, quant)
    x = torch.cat([x[:n], x[n:]], 1)
    x = res_block(p, enc_ab + ".0", x, quant)
    x = res_block(p, enc_ab + ".1", x, quant)
    x = conv_bn_relu(p, enc_ab + ".2", x, 2, quant)
    x = res_block(p, enc_ab + ".3", x, quant)
    x = res_block(p, enc_ab + ".4", x, quant)
    t = x.permute(0, 2, 3, 1).reshape(n, -1, x.shape[1])
    return t + positions(t.shape[-1], t.shape[1], t.device)


def refine_net(p, A, B, heads, quant=None):
    """-> (trans (N, 3), rot (N, 3))."""
    t = tokens(p, "encodeA", "encodeAB", A, B, quant)
    outs = []
    for head in ("trans_head", "rot_head"):
        y = encoder_layer(p, head + ".0", t, heads, quant)
        outs.append(linear(p, head + ".1", y, quant).mean(1))
    return outs[0], outs[1]


def score_pooled(p, A, B, heads, quant=None):
    """The per-pair half of the scorer: (N, D) pooled features."""
    t = tokens(p, "encoderA", "encoderAB", A, B, quant)
    return attention(p, "att", t, heads, quant).mean(1)


def score_logits(p, feats, heads, quant=None):
    """(L, D) pooled features of one group -> (L,) logits."""
    return linear(p, "linear", attention(p, "att_cross", feats[None], heads, quant)[0], quant)[:, 0]


def refine_spec(c_in, w, heads, rot_dim=3):
    """[(state-dict name, shape)] of RefineNet at base width w."""
    spec = _trunk("encodeA", "encodeAB", c_in, w)
    d = 8 * w
    for head, out in (("trans_head", 3), ("rot_head", rot_dim)):
        spec += _encoder(head + ".0", d) + [(head + ".1.weight", (out, d)), (head + ".1.bias", (out,))]
    return spec


def score_spec(c_in, w, heads):
    d = 8 * w
    return (_trunk("encoderA", "encoderAB", c_in, w) + _mha("att", d) + _mha("att_cross", d)
            + [("linear.weight", (1, d)), ("linear.bias", (1,))])


def _cbr(name, cin, cout, k):
    return [(name + ".net.0.weight", (cout, cin, k, k)), (name + ".net.0.bias", (cout,))] + _bn(name + ".net.1", cout)


def _bn(name, c):
    return [(name + s, (c,)) for s in (".weight", ".bias", ".running_mean", ".running_var")] + [
        (name + ".num_batches_tracked", ())]


def _res(name, c):
    return ([(name + ".conv1.weight", (c, c, 3, 3)), (name + ".conv1.bias", (c,)),
             (name + ".conv2.weight", (c, c, 3, 3)), (name + ".conv2.bias", (c,))]
            + _bn(name + ".bn1", c) + _bn(name + ".bn2", c))


def _trunk(a, ab, c_in, w):
    return (_cbr(a + ".0", c_in, w, 7) + _cbr(a + ".1", w, 2 * w, 3) + _res(a + ".2", 2 * w)
            + _res(a + ".3", 2 * w) + _res(ab + ".0", 4 * w) + _res(ab + ".1", 4 * w)
            + _cbr(ab + ".2", 4 * w, 8 * w, 3) + _res(ab + ".3", 8 * w) + _res(ab + ".4", 8 * w))


def _mha(name, d):
    return [(name + ".in_proj_weight", (3 * d, d)), (name + ".in_proj_bias", (3 * d,)),
            (name + ".out_proj.weight", (d, d)), (name + ".out_proj.bias", (d,))]


def _encoder(name, d):
    return (_mha(name + ".self_attn", d) + [(name + ".linear1.weight", (FF, d)), (name + ".linear1.bias", (FF,)),
                                            (name + ".linear2.weight", (d, FF)), (name + ".linear2.bias", (d,))]
            + [(name + n + s, (d,)) for n in (".norm1", ".norm2") for s in (".weight", ".bias")])
