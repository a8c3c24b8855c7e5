"""Multi-level hash-grid encoder (instant-NGP style) on torch tensors.

Port of foundationpose_tpu/ops/hashgrid.py with its three layouts:

* "cuda": index-exact torch-ngp semantics, eight table rows gathered per
  (point, level); the backward's table gradient is K3
  (`segment_add_planes`);
* "oct": the NeRF default. Same trilinear interpolation, but a level's
  eight cell corners sit at the base row plus eight fixed shifts
  (index x + s*y + H(z), H = s^2 dense / z*805459861 hashed), and the
  table is read bf16-rounded. The JAX package gathers from a rolled
  (T, 8C) copy of the table; row i of that copy is
  t[(i - off + shift_q) mod size + off], so the port gathers the eight
  corners straight from a bf16 copy of the table. The backward's table
  gradient is K4 (`factored_segment_add`), which adds each corner's
  product into that same row of the (T, C) gradient (on the CPU its
  plain version folds the JAX package's (T, 8C) rolled-row sums back
  per level with `torch.roll` by the same shifts);
* "quad": the same index, one 4-corner row (the (x, y) corners, shifts
  0, 1, s, s+1) per (point, level, z corner), gathered from the bf16
  table; the table gradient is K3 on the 4C planes of those rows, folded
  back per level by the four shifts.

The points' gradient is differentiable again (create_graph), as the JAX
package's custom-VJP backward is under a second `jax.grad`: its table
term, the cotangent of the gathered corners, is added into their rows by
K3 in every layout ("oct" / "quad": the corner rows, no fold).

Level semantics (every layout): scale = 2^(l*S) * base - 1, sample
position x01*scale + 0.5, out-of-[0, 1] points give zeros and no
gradient. Integer index arithmetic runs in int64 and reproduces the JAX
package's uint32 wraparound where it matters (hashed level sizes are
powers of two dividing 2^32).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import torch_config  # noqa: F401
from ..utils import profiling
from .segment_add import factored_segment_add, segment_add_planes

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
LAYOUTS = ("oct", "cuda", "quad")


@dataclasses.dataclass(frozen=True)
class HashGridCfg:
    n_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 32
    desired_resolution: int = 512
    log2_hashmap_size: int = 22
    # "cuda" (index-exact torch-ngp), "oct" (the NeRF runner's layout) or
    # "quad"; see the module docstring.
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
def oct_levels(cfg: HashGridCfg):
    """K4's level constants: per level its first row and size, and the
    (L, 8) corner shifts (read-only numpy arrays)."""
    _res, sizes, offsets, _total = cfg.level_tables()
    out = (offsets, sizes, oct_shifts(cfg))
    for a in out:
        a.setflags(write=False)
    return out


def quad_shifts(cfg: HashGridCfg) -> np.ndarray:
    """(L, 4) corner row shifts mod the level size, corner order
    q = dy*2 + dx (the quad row's [00, 10, 01, 11])."""
    res_np, sizes_np, _offsets, _total = cfg.level_tables()
    return np.array([[d % int(sizes_np[lv]) for d in (0, 1, int(res_np[lv]) + 1, int(res_np[lv]) + 2)]
                     for lv in range(cfg.n_levels)], np.int64)


@functools.lru_cache(maxsize=16)
def _consts(cfg: HashGridCfg, device: str):
    """Per-level tensors on `device`: scales (L,) f32, sizes, offsets,
    strides, z multipliers h, dense flags, oct shifts (L, 8) and quad
    shifts (L, 4)."""
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
        "quad_shifts": t(quad_shifts(cfg)),
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


def _cuda_table_grad(cfg, table_size, x, g):
    """The table's gradient: K3 over the (point, level, corner) rows."""
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    flat, w, _factors, oob = _corner_data(x, cfg)
    g_lc = torch.where(oob[:, None], 0.0, g).reshape(N, L, C)
    idx = torch.where(oob[:, None, None], table_size, flat).to(torch.int32).reshape(-1)
    upd = torch.stack([(w * g_lc[:, :, ch, None]).reshape(-1) for ch in range(C)])
    return segment_add_planes(idx, upd, table_size)  # K3


def _cuda_point_grad(cfg, x, vals, g):
    """The points' gradient from the gathered corners vals (N, L, 8, C):
    plain tensor operations, differentiable in x, vals and g."""
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    _flat, _w, factors, oob = _corner_data(x, cfg)
    g_lc = torch.where(oob[:, None], 0.0, g).reshape(N, L, C)
    ve_g = torch.zeros_like(factors[0])
    for ch in range(C):
        ve_g = ve_g + vals[..., ch] * g_lc[:, :, ch, None]
    scale = _consts(cfg, str(x.device))["scales"][None, :, None] / 2.0
    sign = [torch.tensor([1.0 if b else -1.0 for b in _BITS[d]], device=x.device) for d in range(3)]
    others = (factors[1] * factors[2], factors[0] * factors[2], factors[0] * factors[1])
    d_x = torch.stack(
        [(ve_g * sign[d] * others[d] * scale).reshape(N, -1).sum(1) for d in range(3)], dim=-1
    )
    return torch.where(oob[:, None], 0.0, d_x)


def _cuda_corner_rows(x, cfg):
    flat, _w, _factors, oob = _corner_data(x, cfg)
    return flat, oob


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


def _oct_table_grad(cfg, table_size, x, g):
    """The table's gradient: K4 adds each (point, level) entry's products
    into its eight corner rows, the base row shifted by the corner shifts."""
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    c = _consts(cfg, str(x.device))
    flat, fx, fy, fz, oob = _oct_corner_data(x, cfg)
    g_lc = torch.where(oob[:, None], 0.0, g).reshape(N, L, C)
    # oob points keep an index inside their level (their updates are
    # zero), as the JAX package does for its per-level sort.
    idx = torch.where(oob[:, None], c["offsets"][None], flat).to(torch.int32)  # (N, L)
    return factored_segment_add(idx, _oct_weights(fx, fy, fz), g_lc, oct_levels(cfg))  # K4, (T, C)


def _oct_point_grad(cfg, x, vals, g):
    """The points' gradient from the gathered bf16 corners vals
    (N, L, 8, C): plain tensor operations, differentiable in x, vals and g."""
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    c = _consts(cfg, str(x.device))
    _flat, fx, fy, fz, oob = _oct_corner_data(x, cfg)
    g_lc = torch.where(oob[:, None], 0.0, g).reshape(N, L, C)
    ve_g = []
    for q in range(8):
        acc = torch.zeros_like(fx)
        for ch in range(C):
            acc = acc + vals[:, :, q, ch].to(torch.float32) * g_lc[:, :, ch]
        ve_g.append(acc)
    wx, wy, wz = (1.0 - fx, fx), (1.0 - fy, fy), (1.0 - fz, fz)

    def corner(dz, dy, dx):
        return ve_g[dz * 4 + dy * 2 + dx]

    dfx = sum(wz[dz] * wy[dy] * (corner(dz, dy, 1) - corner(dz, dy, 0)) for dz in (0, 1) for dy in (0, 1))
    dfy = sum(wz[dz] * wx[dx] * (corner(dz, 1, dx) - corner(dz, 0, dx)) for dz in (0, 1) for dx in (0, 1))
    dfz = sum(wy[dy] * wx[dx] * (corner(1, dy, dx) - corner(0, dy, dx)) for dy in (0, 1) for dx in (0, 1))
    scale = c["scales"][None] / 2.0
    d_x = torch.stack([(dfx * scale).sum(1), (dfy * scale).sum(1), (dfz * scale).sum(1)], dim=-1)
    return torch.where(oob[:, None], 0.0, d_x)


def _oct_corner_rows(x, cfg):
    flat, _fx, _fy, _fz, oob = _oct_corner_data(x, cfg)
    return _oct_rows(flat, cfg), oob


# ------------------------------------------------------------------ quad
#
# Per level the index is (x + s*y + H(z)) mod size (s = res + 1; H = s^2 z
# dense, z * 805459861 hashed), so the four (x, y) corners of a cell at
# one z sit at the rows base + (0, 1, s, s+1): one 4-corner row of the
# JAX package's rolled quad table per (point, level, z corner). The port
# gathers the four corners straight from a bf16 copy of the table, as
# "oct" does for its eight. Slots are level-major, z corner minor: (N, 2L).


def _quad_corner_data(x: torch.Tensor, cfg: HashGridCfg):
    """"quad" layout: base table rows (N, 2L) int64, the fractions fx, fy
    and the z weight wz (N, 2L), and oob (N,)."""
    c = _consts(cfg, str(x.device))
    pg, frac, oob = _positions(x, cfg)
    zbit = torch.tensor([0, 1], dtype=torch.int64, device=x.device)
    lin = (pg[:, 0] + pg[:, 1] * c["strides"])[..., None] + (pg[:, 2][..., None] + zbit) * c["hmul"][:, None]
    flat = (lin % c["sizes"][:, None] + c["offsets"][:, None]).reshape(x.shape[0], -1)

    def slots(a):  # (N, L) -> (N, 2L)
        return a.repeat_interleave(2, dim=1)

    fz = slots(frac[:, 2])
    wz = torch.where(zbit.repeat(cfg.n_levels).bool(), fz, 1.0 - fz)
    return flat, slots(frac[:, 0]), slots(frac[:, 1]), wz, oob


def _quad_weights(fx, fy):
    return [(1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy, fx * fy]


def _quad_rows(flat, cfg):
    """(N, 2L) base rows -> (N, 2L, 4) rows of the four (x, y) corners."""
    c = _consts(cfg, str(flat.device))
    off = c["offsets"].repeat_interleave(2)[:, None]
    size = c["sizes"].repeat_interleave(2)[:, None]
    return (flat[..., None] - off + c["quad_shifts"].repeat_interleave(2, dim=0)) % size + off


def _quad_forward(embeddings, x, cfg):
    N, C = x.shape[0], cfg.level_dim
    flat, fx, fy, wz, oob = _quad_corner_data(x, cfg)
    vals = embeddings.to(torch.bfloat16)[_quad_rows(flat, cfg)]  # (N, 2L, 4, C) bf16
    wq = _quad_weights(fx, fy)
    outs = []
    for ch in range(C):
        acc = torch.zeros_like(fx)
        for q in range(4):
            acc = acc + wq[q] * vals[:, :, q, ch].to(torch.float32)
        outs.append((acc * wz).reshape(N, -1, 2).sum(-1))  # the two z corners of a level
    out = torch.stack(outs, dim=-1)
    return torch.where(oob[:, None, None], 0.0, out).reshape(N, -1), vals


def _quad_table_grad(cfg, table_size, x, g):
    """The table's gradient: K3 over the (point, level, z corner) base rows
    on the 4C planes of the quad row ((4C, M), plane q*C + c), folded back
    per level by the corner shifts."""
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    flat, fx, fy, wz, oob = _quad_corner_data(x, cfg)
    g_lc = torch.where(oob[:, None], 0.0, g).reshape(N, L, C).repeat_interleave(2, dim=1)  # (N, 2L, C)
    wq = _quad_weights(fx, fy)
    idx = torch.where(oob[:, None], table_size, flat).to(torch.int32).reshape(-1)
    upd = torch.stack([(wz * wq[q] * g_lc[..., ch]).reshape(-1) for q in range(4) for ch in range(C)])
    dq = segment_add_planes(idx, upd, table_size)  # K3, (T, 4C)
    _res, sizes_np, offsets_np, _ = cfg.level_tables()
    shifts = quad_shifts(cfg)
    segs = []
    for lv in range(L):
        dql = dq[int(offsets_np[lv]) : int(offsets_np[lv] + sizes_np[lv])]
        acc = dql[:, 0:C]
        for q in range(1, 4):
            acc = acc + torch.roll(dql[:, q * C : (q + 1) * C], int(shifts[lv, q]), dims=0)
        segs.append(acc)
    return torch.cat(segs)


def _quad_point_grad(cfg, x, vals, g):
    """The points' gradient from the gathered bf16 corners vals
    (N, 2L, 4, C): plain tensor operations, differentiable in x, vals and g."""
    N, L, C = x.shape[0], cfg.n_levels, cfg.level_dim
    c = _consts(cfg, str(x.device))
    _flat, fx, fy, wz, oob = _quad_corner_data(x, cfg)
    g_lc = torch.where(oob[:, None], 0.0, g).reshape(N, L, C).repeat_interleave(2, dim=1)
    ve_g = []
    for q in range(4):
        acc = torch.zeros_like(fx)
        for ch in range(C):
            acc = acc + vals[:, :, q, ch].to(torch.float32) * g_lc[..., ch]
        ve_g.append(acc)
    wq = _quad_weights(fx, fy)
    dfx = wz * ((1.0 - fy) * (ve_g[1] - ve_g[0]) + fy * (ve_g[3] - ve_g[2]))
    dfy = wz * ((1.0 - fx) * (ve_g[2] - ve_g[0]) + fx * (ve_g[3] - ve_g[1]))
    sq = torch.zeros_like(fx)
    for q in range(4):
        sq = sq + wq[q] * ve_g[q]
    zsign = torch.tensor([-1.0, 1.0], device=x.device).repeat(L)
    dfz = zsign * sq
    scale = c["scales"].repeat_interleave(2)[None] / 2.0
    d_x = torch.stack([(dfx * scale).sum(1), (dfy * scale).sum(1), (dfz * scale).sum(1)], dim=-1)
    return torch.where(oob[:, None], 0.0, d_x)


def _quad_corner_rows(x, cfg):
    flat, _fx, _fy, _wz, oob = _quad_corner_data(x, cfg)
    return _quad_rows(flat, cfg), oob


# ------------------------------------------------------------- autograd

_LAYOUT_FNS = {
    # forward, table gradient, point gradient, corner rows, corner dtype
    "cuda": (_cuda_forward, _cuda_table_grad, _cuda_point_grad, _cuda_corner_rows, torch.float32),
    "oct": (_oct_forward, _oct_table_grad, _oct_point_grad, _oct_corner_rows, torch.bfloat16),
    "quad": (_quad_forward, _quad_table_grad, _quad_point_grad, _quad_corner_rows, torch.bfloat16),
}


def corner_table_grad(idx: torch.Tensor, upd: torch.Tensor, table_size: int) -> torch.Tensor:
    """The table gradient of gathered corners: idx (M,) rows (table_size
    for a dropped point), upd (C, M) f32 -> (table_size, C), K3. The
    second-order table term reaches K3 only through this function."""
    return segment_add_planes(idx, upd, table_size)


class _GatherRows(torch.autograd.Function):
    """table[rows] in `dtype`, rows (N, L, 8): the corners the point
    gradient reads, as a function of the table. Its backward adds the
    corners' cotangent into their rows with K3 (`corner_table_grad`),
    dropping the points where `keep` is False. A bf16 corner's cotangent
    arrives rounded to bf16, as in the JAX package, whose transposed
    gather then adds in bf16; K3 adds in f32."""

    @staticmethod
    def forward(ctx, table, rows, keep, dtype):
        ctx.save_for_backward(rows, keep)
        ctx.table_size = table.shape[0]
        return table[rows].to(dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_vals):
        rows, keep = ctx.saved_tensors
        T, C = ctx.table_size, g_vals.shape[-1]
        idx = torch.where(keep[:, None, None], rows, T).to(torch.int32).reshape(-1)
        upd = torch.empty((C, idx.numel()), dtype=torch.float32, device=g_vals.device)
        upd.view(C, *g_vals.shape[:-1]).copy_(g_vals.movedim(-1, 0))  # one cast-and-transpose pass
        return corner_table_grad(idx, upd, T), None, None, None


class _HashGridEncode(torch.autograd.Function):
    """The encoder. Its backward gives the table's gradient (K3 or K4, when
    `table_grad`) and the points' gradient. Under create_graph the points'
    gradient is itself differentiable: in the points, in the cotangent and,
    through the corners gathered again by `_GatherRows`, in the table (the
    second-order table term of an eikonal loss, which K3 adds). The table
    gradient itself is not differentiated again."""

    @staticmethod
    def forward(ctx, embeddings, x, cfg, table_grad):
        fwd = _LAYOUT_FNS[cfg.layout][0]
        out, vals = fwd(embeddings, x, cfg)
        ctx.cfg, ctx.table_grad = cfg, table_grad
        ctx.save_for_backward(embeddings, x, vals)
        return out

    @staticmethod
    def backward(ctx, g):
        embeddings, x, vals = ctx.saved_tensors
        cfg = ctx.cfg
        _, table_grad, point_grad, corner_rows, dtype = _LAYOUT_FNS[cfg.layout]
        g = g.to(torch.float32).contiguous()
        d_emb = d_x = None
        if ctx.table_grad and ctx.needs_input_grad[0]:
            # A NeRF step's device stage nerf.grid_backward (utils/profiling.py;
            # on a card this runs on autograd's worker thread, on the step's
            # stream); the rest of the backward is nerf.backward again.
            profiling.mark("nerf.grid_backward")
            with torch.no_grad():
                d_emb = table_grad(cfg, embeddings.shape[0], x, g)
            profiling.mark("nerf.backward")
        if ctx.needs_input_grad[1]:
            if torch.is_grad_enabled() and embeddings.requires_grad:
                rows, oob = corner_rows(x.detach(), cfg)
                vals = _GatherRows.apply(embeddings, rows, ~oob, dtype)
            d_x = point_grad(cfg, x, vals, g)
        return d_emb, d_x, None, None


def hashgrid_encode(embeddings: torch.Tensor, x: torch.Tensor, cfg: HashGridCfg,
                    table_grad: bool = True) -> torch.Tensor:
    """embeddings (T, C) f32, x (N, 3) in [-1, 1] -> (N, L*C) f32, channel
    order level-major. Differentiable in both inputs; the table gradient
    runs K3 ("cuda", "quad") or K4 ("oct"). `table_grad=False` drops this call's
    own table gradient (and its kernel launch) while keeping the points'
    gradient and, under create_graph, its table term: an eikonal loss
    reads the encoder only through the points' gradient."""
    if cfg.layout not in LAYOUTS:
        raise NotImplementedError(
            f"hash-grid layout {cfg.layout!r} is not ported (ported: {', '.join(LAYOUTS)})"
        )
    return _HashGridEncode.apply(embeddings, x, cfg, table_grad)
