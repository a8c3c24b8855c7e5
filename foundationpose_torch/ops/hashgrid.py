"""Multi-level hash-grid encoder (instant-NGP style) on torch tensors.

Port of foundationpose_tpu/ops/hashgrid.py with its two layouts that the
NeRF runner uses:

* "cuda": index-exact torch-ngp semantics, eight table rows gathered per
  (point, level); the backward's table gradient is K3
  (`segment_add_planes`);
* "oct": the NeRF default. Same trilinear interpolation, but a level's
  eight cell corners sit at the base row plus eight fixed shifts
  (index x + s*y + H(z), H = s^2 dense / z*805459861 hashed), and the
  table is read bf16-rounded. The JAX package gathers from a rolled
  (T, 8C) copy of the table; row i of that copy is
  t[(i - off + shift_q) mod size + off], so the port gathers the eight
  corners straight from a bf16 copy of the table. The backward's
  gradient of the rolled rows is K4 (`factored_segment_add`), folded
  back per level with `torch.roll` by the same shifts.

Level semantics (both layouts): scale = 2^(l*S) * base - 1, sample
position x01*scale + 0.5, out-of-[0, 1] points give zeros and no
gradient. The "quad" layout is not ported. Integer index arithmetic runs
in int64 and reproduces the JAX package's uint32 wraparound where it
matters (hashed level sizes are powers of two dividing 2^32).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import torch_config  # noqa: F401
from .segment_add import factored_segment_add, segment_add_planes

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
LAYOUTS = ("oct", "cuda")


@dataclasses.dataclass(frozen=True)
class HashGridCfg:
    n_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 32
    desired_resolution: int = 512
    log2_hashmap_size: int = 22
    # "cuda" (index-exact torch-ngp) or "oct" (the NeRF runner's layout);
    # see the module docstring.
    layout: str = "cuda"

    @property
    def per_level_scale(self) -> float:
        return float(
            np.exp2(
                np.log2(self.desired_resolution / self.base_resolution)
                / max(self.n_levels - 1, 1)
            )
        )

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.level_dim

    def level_tables(self):
        """Per-level (resolution, hashmap_size, offset) numpy arrays and
        the total row count."""
        max_params = 2**self.log2_hashmap_size
        res, sizes, offsets = [], [], []
        offset = 0
        for lv in range(self.n_levels):
            scale = np.exp2(lv * np.log2(self.per_level_scale)) * self.base_resolution - 1.0
            resolution = int(np.ceil(scale)) + 1
            params = min(max_params, (resolution + 1) ** 3)
            params = int(np.ceil(params / 8) * 8)
            res.append(resolution)
            sizes.append(params)
            offsets.append(offset)
            offset += params
        return (
            np.array(res, np.int64),
            np.array(sizes, np.int64),
            np.array(offsets, np.int64),
            offset,
        )


def init_hashgrid(cfg: HashGridCfg, generator: torch.Generator, device="cpu") -> torch.Tensor:
    """(total, level_dim) f32 table, uniform in [-1e-4, 1e-4)."""
    _, _, _, total = cfg.level_tables()
    u = torch.rand((total, cfg.level_dim), generator=generator, device=generator.device)
    return (u * 2e-4 - 1e-4).to(device)


def _level_scales(cfg: HashGridCfg) -> np.ndarray:
    lv = np.arange(cfg.n_levels, dtype=np.float64)
    return (np.exp2(lv * np.log2(cfg.per_level_scale)) * cfg.base_resolution - 1.0).astype(
        np.float32
    )


def oct_shifts(cfg: HashGridCfg) -> np.ndarray:
    """(L, 8) corner row shifts mod the level size, corner order
    q = dz*4 + dy*2 + dx."""
    res_np, sizes_np, _offsets, _total = cfg.level_tables()
    dense = ((res_np + 1) ** 3) <= sizes_np
    out = []
    for lv in range(cfg.n_levels):
        s = int(res_np[lv]) + 1
        h = s * s if dense[lv] else _PRIMES[2]
        size = int(sizes_np[lv])
        out.append([(dz * h + dy * s + dx) % size for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)])
    return np.array(out, np.int64)


@functools.lru_cache(maxsize=16)
def _consts(cfg: HashGridCfg, device: str):
    """Per-level tensors on `device`: scales (L,) f32, sizes, offsets,
    strides, z multipliers h, dense flags and oct shifts (L, 8)."""
    res_np, sizes_np, offsets_np, _total = cfg.level_tables()
    strides = res_np + 1
    dense = (strides**3) <= sizes_np
    hmul = np.where(dense, strides * strides, _PRIMES[2])

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return {
        "scales": t(_level_scales(cfg), torch.float32),
        "sizes": t(sizes_np),
        "offsets": t(offsets_np),
        "strides": t(strides),
        "hmul": t(hmul),
        "dense": t(dense, torch.bool),
        "shifts": t(oct_shifts(cfg)),
    }


# Corner k of a cell: bit d of k is the offset along axis d (k = dx + 2dy + 4dz).
_BITS = [[(k >> d) & 1 for k in range(8)] for d in range(3)]


def _positions(x: torch.Tensor, cfg: HashGridCfg):
    """-> (integer cell corner (N, 3, L) int64, fractions (N, 3, L), oob (N,))."""
    c = _consts(cfg, str(x.device))
    x01 = (x + 1.0) / 2.0
    oob = torch.any((x01 < 0.0) | (x01 > 1.0), dim=-1)
    # x01 * scale + 0.5 rounded once, as the JAX package's compiled graph
    # rounds it (a fused multiply-add; the f64 product of two f32 is exact)
    pos = (x01[:, :, None].double() * c["scales"][None, None].double() + 0.5).to(torch.float32)
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    return pos_grid.to(torch.int64), frac, oob


# ------------------------------------------------------------------ cuda


def _corner_data(x: torch.Tensor, cfg: HashGridCfg):
    """"cuda" layout: flat table rows (N, L, 8) int64, trilinear weights
    (N, L, 8), per-axis factors 3 x (N, L, 8) and oob (N,)."""
    c = _consts(cfg, str(x.device))
    pg, frac, oob = _positions(x, cfg)
    bits = torch.tensor(_BITS, dtype=torch.int64, device=x.device)  # (3, 8)
    corner = [pg[:, d, :, None] + bits[d] for d in range(3)]  # 3 x (N, L, 8)
    factors = [
        torch.where(bits[d].bool(), frac[:, d, :, None], 1.0 - frac[:, d, :, None])
        for d in range(3)
    ]
    w = factors[0] * factors[1] * factors[2]
    stride = c["strides"][None, :, None]
    linear = corner[0] + corner[1] * stride + corner[2] * stride * stride
    hashed = (
        ((corner[0] * _PRIMES[0]) & _MASK32)
        ^ ((corner[1] * _PRIMES[1]) & _MASK32)
        ^ ((corner[2] * _PRIMES[2]) & _MASK32)
    )
    idx = torch.where(c["dense"][None, :, None], linear, hashed) % c["sizes"][None, :, None]
    return idx + c["offsets"][None, :, None], w, factors, oob


def _cuda_forward(embeddings, x, cfg):
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    flat, w, _factors, oob = _corner_data(x, cfg)
    vals = embeddings[flat]  # (N, L, 8, C) f32
    out = torch.stack([(vals[..., ch] * w).sum(-1) for ch in range(C)], dim=-1)
    out = torch.where(oob[:, None, None], 0.0, out).reshape(N, L * C)
    return out, vals


def _cuda_backward(cfg, table_size, x, vals, g, need_emb):
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    flat, w, factors, oob = _corner_data(x, cfg)
    g_lc = torch.where(oob[:, None], 0.0, g).reshape(N, L, C)
    g_slots = [g_lc[:, :, ch, None] for ch in range(C)]  # broadcast over the 8 corners
    d_emb = None
    if need_emb:
        idx = torch.where(oob[:, None, None], table_size, flat).to(torch.int32).reshape(-1)
        upd = torch.stack([(w * g_slots[ch]).reshape(-1) for ch in range(C)])
        d_emb = segment_add_planes(idx, upd, table_size)  # K3
    ve_g = torch.zeros_like(w)
    for ch in range(C):
        ve_g = ve_g + vals[..., ch] * g_slots[ch]
    scale = _consts(cfg, str(x.device))["scales"][None, :, None] / 2.0
    sign = [torch.tensor([1.0 if b else -1.0 for b in _BITS[d]], device=x.device) for d in range(3)]
    others = (factors[1] * factors[2], factors[0] * factors[2], factors[0] * factors[1])
    d_x = torch.stack(
        [(ve_g * sign[d] * others[d] * scale).reshape(N, -1).sum(1) for d in range(3)], dim=-1
    )
    return d_emb, torch.where(oob[:, None], 0.0, d_x)


# ------------------------------------------------------------------- oct


def _oct_corner_data(x: torch.Tensor, cfg: HashGridCfg):
    """"oct" layout: base table rows (N, L) int64, fractions fx, fy, fz
    (N, L) and oob (N,)."""
    c = _consts(cfg, str(x.device))
    pg, frac, oob = _positions(x, cfg)
    lin = pg[:, 0] + pg[:, 1] * c["strides"] + pg[:, 2] * c["hmul"]
    flat = lin % c["sizes"] + c["offsets"]
    return flat, frac[:, 0], frac[:, 1], frac[:, 2], oob


def _oct_weights(fx, fy, fz):
    """Eight trilinear corner weights, order q = dz*4 + dy*2 + dx."""
    wx, wy, wz = (1.0 - fx, fx), (1.0 - fy, fy), (1.0 - fz, fz)
    return [wz[dz] * wy[dy] * wx[dx] for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


def _oct_rows(flat, cfg):
    """(N, L) base rows -> (N, L, 8) rows of the eight corners."""
    c = _consts(cfg, str(flat.device))
    off, size = c["offsets"][:, None], c["sizes"][:, None]
    return (flat[..., None] - off + c["shifts"]) % size + off


def _oct_forward(embeddings, x, cfg):
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    flat, fx, fy, fz, oob = _oct_corner_data(x, cfg)
    vals = embeddings.to(torch.bfloat16)[_oct_rows(flat, cfg)]  # (N, L, 8, C) bf16
    w8 = _oct_weights(fx, fy, fz)
    outs = []
    for ch in range(C):
        acc = torch.zeros_like(fx)
        for q in range(8):
            acc = acc + w8[q] * vals[:, :, q, ch].to(torch.float32)
        outs.append(acc)
    out = torch.stack(outs, dim=-1)
    out = torch.where(oob[:, None, None], 0.0, out).reshape(N, L * C)
    return out, vals


def _oct_backward(cfg, table_size, x, vals, g, need_emb):
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    c = _consts(cfg, str(x.device))
    flat, fx, fy, fz, oob = _oct_corner_data(x, cfg)
    g_lc = torch.where(oob[:, None], 0.0, g).reshape(N, L, C)
    g_slots = [g_lc[:, :, ch] for ch in range(C)]
    w8 = _oct_weights(fx, fy, fz)
    d_emb = None
    if need_emb:
        # oob points keep an index inside their level (their updates are
        # zero), as the JAX package does for its per-level sort.
        idx_lv = torch.where(oob[:, None], c["offsets"][None], flat).T.to(torch.int32)
        w_planes = torch.stack([wq.T for wq in w8])  # (8, L, N)
        g_planes = g_lc.permute(2, 1, 0)  # (C, L, N)
        dq = factored_segment_add(idx_lv, w_planes, g_planes, table_size)  # K4, (T, 8C)
        res_np, sizes_np, offsets_np, _ = cfg.level_tables()
        shifts = oct_shifts(cfg)
        segs = []
        for lv in range(L):
            dql = dq[int(offsets_np[lv]) : int(offsets_np[lv] + sizes_np[lv])]
            acc = dql[:, 0:C]
            for q in range(1, 8):
                acc = acc + torch.roll(dql[:, q * C : (q + 1) * C], int(shifts[lv, q]), dims=0)
            segs.append(acc)
        d_emb = torch.cat(segs)
    ve_g = []
    for q in range(8):
        acc = torch.zeros_like(fx)
        for ch in range(C):
            acc = acc + vals[:, :, q, ch].to(torch.float32) * g_slots[ch]
        ve_g.append(acc)
    wx, wy, wz = (1.0 - fx, fx), (1.0 - fy, fy), (1.0 - fz, fz)

    def corner(dz, dy, dx):
        return ve_g[dz * 4 + dy * 2 + dx]

    dfx = sum(wz[dz] * wy[dy] * (corner(dz, dy, 1) - corner(dz, dy, 0)) for dz in (0, 1) for dy in (0, 1))
    dfy = sum(wz[dz] * wx[dx] * (corner(dz, 1, dx) - corner(dz, 0, dx)) for dz in (0, 1) for dx in (0, 1))
    dfz = sum(wy[dy] * wx[dx] * (corner(1, dy, dx) - corner(0, dy, dx)) for dy in (0, 1) for dx in (0, 1))
    scale = c["scales"][None] / 2.0
    d_x = torch.stack([(dfx * scale).sum(1), (dfy * scale).sum(1), (dfz * scale).sum(1)], dim=-1)
    return d_emb, torch.where(oob[:, None], 0.0, d_x)


# ------------------------------------------------------------- autograd


class _HashGridEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, embeddings, x, cfg):
        fwd = _oct_forward if cfg.layout == "oct" else _cuda_forward
        out, vals = fwd(embeddings, x, cfg)
        ctx.cfg = cfg
        ctx.table_size = embeddings.shape[0]
        ctx.save_for_backward(x, vals)
        return out

    @staticmethod
    def backward(ctx, g):
        x, vals = ctx.saved_tensors
        bwd = _oct_backward if ctx.cfg.layout == "oct" else _cuda_backward
        d_emb, d_x = bwd(
            ctx.cfg, ctx.table_size, x, vals, g.to(torch.float32).contiguous(),
            ctx.needs_input_grad[0],
        )
        return d_emb, (d_x if ctx.needs_input_grad[1] else None), None


def hashgrid_encode(embeddings: torch.Tensor, x: torch.Tensor, cfg: HashGridCfg) -> torch.Tensor:
    """embeddings (T, C) f32, x (N, 3) in [-1, 1] -> (N, L*C) f32, channel
    order level-major. Differentiable in both inputs; the table gradient
    runs K3 ("cuda") or K4 ("oct")."""
    if cfg.layout not in LAYOUTS:
        raise NotImplementedError(
            f"hash-grid layout {cfg.layout!r} is not ported (ported: {', '.join(LAYOUTS)})"
        )
    return _HashGridEncode.apply(embeddings, x, cfg)
