"""RefineNet and ScoreNetMultiPair as nn.Modules.

Port of foundationpose_tpu/models/networks.py (reference
learning/models/refine_network.py, score_network.py): a shared conv
trunk encodes the rendered (A) and observed (B) crops, the concatenated
features pass a second trunk, the 20x20 map becomes 400 row-major tokens
with sinusoidal positions, and transformer heads regress the pose delta
(refiner) or cross-hypothesis scores (scorer).

Inputs are NHWC (N, res, res, c_in), as in the JAX package. Widths
scale with `base_width` (64 is the reference network).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from . import layers as L


@dataclasses.dataclass(frozen=True)
class RefineNetCfg:
    c_in: int = 6
    use_bn: bool = True
    rot_rep: str = "axis_angle"  # or "6d"
    num_heads: int = 4
    base_width: int = 64

    @property
    def embed_dim(self) -> int:
        return self.base_width * 8

    @property
    def rot_dim(self) -> int:
        return 3 if self.rot_rep == "axis_angle" else 6


@dataclasses.dataclass(frozen=True)
class ScoreNetCfg:
    c_in: int = 6
    use_bn: bool = True
    num_heads: int = 4
    base_width: int = 64

    @property
    def embed_dim(self) -> int:
        return self.base_width * 8


def _encode_a(c_in, use_bn, w):
    return nn.ModuleList([
        L.ConvBNReLU(c_in, w, 7, 2, use_bn),
        L.ConvBNReLU(w, 2 * w, 3, 2, use_bn),
        L.ResnetBasicBlock(2 * w, use_bn),
        L.ResnetBasicBlock(2 * w, use_bn),
    ])


def _encode_ab(use_bn, w):
    return nn.ModuleList([
        L.ResnetBasicBlock(4 * w, use_bn),
        L.ResnetBasicBlock(4 * w, use_bn),
        L.ConvBNReLU(4 * w, 8 * w, 3, 2, use_bn),
        L.ResnetBasicBlock(8 * w, use_bn),
        L.ResnetBasicBlock(8 * w, use_bn),
    ])


def _run(mods, x, dtype):
    for m in mods:
        x = m(x, dtype)
    return x


def _tokens(enc_a, enc_ab, A, B, embed_dim, dtype):
    """Shared trunk: (N, H, W, c) pairs -> (N, L, D) tokens + positions."""
    n = A.shape[0]
    x = torch.cat([A, B], dim=0).to(dtype).permute(0, 3, 1, 2)  # NCHW
    x = _run(enc_a, x, dtype)
    ab = _run(enc_ab, torch.cat([x[:n], x[n:]], dim=1), dtype)
    # NHWC before flattening: tokens are the row-major 20x20 positions.
    tokens = ab.permute(0, 2, 3, 1).reshape(n, -1, embed_dim)
    pe = L.positional_embedding(embed_dim, tokens.shape[1], tokens.device).to(dtype)
    return tokens + pe


class RefineNet(nn.Module):
    def __init__(self, cfg: RefineNetCfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.encodeA = _encode_a(cfg.c_in, cfg.use_bn, cfg.base_width)
        self.encodeAB = _encode_ab(cfg.use_bn, cfg.base_width)
        self.trans_head = nn.ModuleList(
            [L.TransformerEncoderLayer(d, cfg.num_heads, 512), L.Linear(d, 3)]
        )
        self.rot_head = nn.ModuleList(
            [L.TransformerEncoderLayer(d, cfg.num_heads, 512), L.Linear(d, cfg.rot_dim)]
        )

    def forward(self, A, B, dtype=torch.bfloat16):
        """A, B (N, res, res, c_in) -> {'trans': (N, 3), 'rot': (N, rot_dim)}."""
        tokens = _tokens(self.encodeA, self.encodeAB, A, B, self.cfg.embed_dim, dtype)
        trans = _run(self.trans_head, tokens, dtype).mean(dim=1)
        rot = _run(self.rot_head, tokens, dtype).mean(dim=1)
        return {"trans": trans.to(torch.float32), "rot": rot.to(torch.float32)}


class ScoreNetMultiPair(nn.Module):
    def __init__(self, cfg: ScoreNetCfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.encoderA = _encode_a(cfg.c_in, cfg.use_bn, cfg.base_width)
        self.encoderAB = _encode_ab(cfg.use_bn, cfg.base_width)
        self.att = L.MultiheadAttention(d, cfg.num_heads)
        self.att_cross = L.MultiheadAttention(d, cfg.num_heads)
        self.linear = L.Linear(d, 1)

    def forward(self, A, B, dtype=torch.bfloat16):
        """A, B (L, res, res, c_in) -> score logits (L,): self-attention
        per pair, mean-pool, cross-attention over the L hypotheses of one
        comparison group."""
        return self.group_logits(self.pooled(A, B, dtype), dtype)

    def pooled(self, A, B, dtype=torch.bfloat16):
        """The per-pair half: trunk, self-attention, mean-pool -> (L, D).
        Pairs are independent here; a hypothesis-sharded register runs it
        on each shard's device."""
        tokens = _tokens(self.encoderA, self.encoderAB, A, B, self.cfg.embed_dim, dtype)
        return self.att(tokens, dtype).mean(dim=1)

    def group_logits(self, feats, dtype=torch.bfloat16):
        """The cross-hypothesis half: pooled features (L, D) of one
        comparison group -> logits (L,)."""
        group = self.att_cross(feats[None], dtype)  # (1, L, D)
        return self.linear(group, dtype)[0, :, 0].to(torch.float32)


def init_refine_net(cfg: RefineNetCfg, generator: torch.Generator) -> RefineNet:
    """RefineNet with weights drawn from `generator` (f32, on the CPU)."""
    return L.init_weights_(RefineNet(cfg), generator).eval()


def init_score_net(cfg: ScoreNetCfg, generator: torch.Generator) -> ScoreNetMultiPair:
    return L.init_weights_(ScoreNetMultiPair(cfg), generator).eval()


def apply_refine_net(net: RefineNet, cfg: RefineNetCfg, A, B, dtype=torch.bfloat16):
    """The JAX package's functional form of RefineNet.forward; `cfg` must
    be the net's own."""
    if cfg != net.cfg:
        raise ValueError(f"cfg {cfg} is not the net's {net.cfg}")
    return net(A, B, dtype=dtype)


def apply_score_net(net: ScoreNetMultiPair, cfg: ScoreNetCfg, A, B, dtype=torch.bfloat16):
    """The JAX package's functional form of ScoreNetMultiPair.forward."""
    if cfg != net.cfg:
        raise ValueError(f"cfg {cfg} is not the net's {net.cfg}")
    return net(A, B, dtype=dtype)
