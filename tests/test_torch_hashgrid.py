"""The hash-grid encoder and the segment-adds K3 / K4 of
foundationpose_torch against foundationpose_tpu on the same numpy inputs.

K3 and K4 run their plain versions here (CPU tensors); they are held
against the Pallas kernels in interpret mode within the bounds of
tests/test_hashgrid.py (the TPU kernels split each update into hi/lo
bf16 halves) and against the JAX package's off-TPU fallbacks within 1e-5.
K3's kernel cannot run here: a torch replay of its schedule (spans of
consecutive updates, runs of one row summed per lane entry, one addition
per run) is held against the Pallas kernel instead. chip_smoke.py is imported from the repository root
for its distinct-row counter. The "quad" layout: its rolled table's rows,
and its table gradient (K3 on 4C = 8 planes, then the roll fold) against
the JAX backward with the Pallas K3 in interpret mode.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import distinct_rows, k3_reductions
from foundationpose_tpu.ops import hashgrid as jhg
from foundationpose_tpu.ops import pallas_scatter as jps
from foundationpose_torch.ops import hashgrid as thg
from foundationpose_torch.ops.segment_add import (
    factored_segment_add,
    factored_segment_add_plain,
    segment_add_planes,
    segment_add_planes_plain,
)
from foundationpose_torch.ops.segment_add_cuda import _k3_geometry


def _flat_case(kind, seed=3):
    """(idx (M,) int32, upd (C, M) f32, table size) with duplicates and,
    for 'sentinel', 1% of the indices at the drop sentinel T."""
    rng = np.random.default_rng(seed)
    M, TBL, C = 4096, 1500, 2
    idx = rng.integers(0, TBL, M).astype(np.int32)
    idx[:1500] = 3  # heavy duplication
    if kind == "sentinel":
        idx[rng.choice(M, M // 100, replace=False)] = TBL
    return idx, rng.normal(size=(C, M)).astype(np.float32), TBL


def _leveled_case(seed=5, oob_zero=False):
    """Per-level indices (L, N) inside their level's segment, weights
    (8, L, N), cotangents (C, L, N); with oob_zero 1% of the entries
    carry zero cotangents at their level's first row, as the hash-grid
    backward sends out-of-bounds points."""
    rng = np.random.default_rng(seed)
    L, N, NW, C = 3, 700, 8, 2
    starts, sizes, TBL = np.array([0, 400, 1000]), np.array([400, 600, 800]), 1800
    idx = np.stack([starts[lv] + rng.integers(0, sizes[lv], N) for lv in range(L)]).astype(np.int32)
    idx[:, :40] = starts[:, None] + 7  # duplicates
    w = rng.uniform(0, 1, size=(NW, L, N)).astype(np.float32)
    g = rng.normal(size=(C, L, N)).astype(np.float32)
    if oob_zero:
        sel = rng.uniform(size=(L, N)) < 0.01
        idx[sel] = np.broadcast_to(starts[:, None], (L, N))[sel]
        g[:, sel] = 0.0
    return idx, w, g, TBL


@pytest.mark.parametrize("kind", ["duplicates", "sentinel"])
def test_k3_plain_vs_pallas_interpret_and_fallback(kind):
    idx, upd, TBL = _flat_case(kind)
    got = segment_add_planes(torch.as_tensor(idx), torch.as_tensor(upd), TBL).numpy()
    pallas = np.asarray(
        jps._segment_add_flat(jnp.asarray(idx), jnp.asarray(upd), TBL, block=256, interpret=True)
    )
    fallback = np.asarray(jps.sorted_segment_add_planes(jnp.asarray(idx), jnp.asarray(upd), TBL))
    assert got.shape == (TBL, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=3e-4, atol=5e-4)
    np.testing.assert_allclose(got, fallback, rtol=1e-5, atol=1e-5)
    want = np.zeros((TBL, 2), np.float32)
    keep = idx < TBL
    np.add.at(want, idx[keep], upd[:, keep].T)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _k3_replay(idx, upd, table_size):
    """K3's schedule (csrc/segment_add.cu) in torch, its warps taken in
    order: each warp walks a span of S consecutive updates 128 at a time,
    lane l taking entries 4l .. 4l + 3 of each step; per entry a run of
    one row is summed, and an entry with another row (or the span's end)
    first adds the run into the output; rows outside [0, table_size) are
    dropped; W channels a pass. Returns (out, the reductions issued)."""
    C, M = upd.shape
    S, W = _k3_geometry(C)
    out = torch.zeros((table_size, C))
    n_red = 0
    for c0 in range(0, C, W):
        for first in range(0, M, S):
            end = min(first + S, M)
            for col in range(128):
                run_row, run = -1, torch.zeros(W)
                for i in range(first + col, end, 128):
                    row = int(idx[i]) if 0 <= int(idx[i]) < table_size else -1
                    v = upd[c0 : c0 + W, i]
                    if row == run_row:
                        run = run + v
                        continue
                    if run_row >= 0:
                        out[run_row, c0 : c0 + W] += run
                        n_red += 1
                    run_row, run = row, v
                if run_row >= 0:
                    out[run_row, c0 : c0 + W] += run
                    n_red += 1
    return out, n_red


def _check_replay(idx, upd, table_size):
    """The replay against the Pallas kernel in interpret mode, the JAX
    fallback and a float64 numpy sum, per row of the sum of |update|:
    within 2^-15 of it against the Pallas kernel (its hi/lo bf16 split
    represents each update to 2^-16 relative: the hi half is the mantissa
    cut to 8 bits, the lo half that rest rounded to bf16; the f32 sums run
    in other orders), within 1e-5 against the others (f32 sums in another
    order; the card's gate in chip_smoke.py). Returns (out, reductions)."""
    got, n_red = _k3_replay(torch.as_tensor(idx), torch.as_tensor(upd), table_size)
    got = got.numpy()
    C = upd.shape[0]
    keep = (idx >= 0) & (idx < table_size)
    want = np.zeros((table_size, C))
    abs_sum = np.zeros((table_size, C))
    np.add.at(want, idx[keep], upd[:, keep].T.astype(np.float64))
    np.add.at(abs_sum, idx[keep], np.abs(upd[:, keep].T.astype(np.float64)))
    pallas = np.asarray(
        jps._segment_add_flat(jnp.asarray(idx), jnp.asarray(upd), table_size, block=256, interpret=True)
    )
    fallback = np.asarray(jps.sorted_segment_add_planes(jnp.asarray(idx), jnp.asarray(upd), table_size))
    assert got.shape == (table_size, C) and got.dtype == np.float32
    assert (np.abs(got - pallas) <= 2.0**-15 * abs_sum + 1e-30).all()
    assert (np.abs(got - fallback) <= 1e-5 * abs_sum + 1e-30).all()
    assert (np.abs(got - want) <= 1e-5 * abs_sum + 1e-30).all()
    return got, n_red


@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_k3_schedule_replay_matches_pallas(C):
    """Two whole spans and a ragged one (M not a multiple of S), a run of
    one row across the first span boundary, 1% drop sentinels."""
    S = _k3_geometry(C)[0]
    M, TBL = 2 * S + 123, 1500
    rng = np.random.default_rng(C)
    idx = rng.integers(0, TBL, M).astype(np.int32)
    idx[S - 50 : S + 50] = 7
    idx[rng.choice(M, M // 100, replace=False)] = TBL
    upd = rng.normal(size=(C, M)).astype(np.float32)
    got, _ = _check_replay(idx, upd, TBL)
    np.testing.assert_allclose(got[7], upd[:, idx == 7].sum(1), rtol=1e-5)


def _ray_points(n_rays, n_samples, seed):
    """Samples ray by ray, as the NeRF runner sends them: rays from 1.4
    units out through the unit cube's middle, stratified along each ray,
    some points outside [-1, 1]^3."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3))
    o = 1.4 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.3, 0.3, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.linspace(0.2, 2.6, n_samples)[None] + rng.uniform(0, 2.4 / n_samples, (n_rays, n_samples))
    return (o[:, None] + d[:, None] * t[..., None]).reshape(-1, 3).astype(np.float32)


def test_k3_schedule_replay_on_corner_stream(monkeypatch):
    """The stream the "cuda"-layout backward sends K3, in its order (the
    (point, level, corner) rows of the samples ray by ray; 16 levels, as
    NerfCfg has), captured around the backward's call. Consecutive points
    share cell corners, so an entry often has the row of the entry 128
    updates before it: fewer reductions than updates, as chip_smoke.py
    counts them."""
    _, tcfg = _cfgs("cuda", 16, 10)
    T = tcfg.level_tables()[3]
    x = torch.as_tensor(_ray_points(4, 96, seed=7))
    grabbed = []

    def grab(idx, upd, table_size):
        grabbed.append((idx.numpy().copy(), upd.numpy().copy(), table_size))
        return segment_add_planes(idx, upd, table_size)

    monkeypatch.setattr(thg, "segment_add_planes", grab)
    emb = torch.zeros((T, 2), requires_grad=True)
    g = torch.as_tensor(np.random.default_rng(8).normal(size=(len(x), tcfg.out_dim)).astype(np.float32))
    thg.hashgrid_encode(emb, x, tcfg).backward(g)
    (idx, upd, table_size), = grabbed
    assert table_size == T and idx.shape == (len(x) * 16 * 8,) and (idx == T).any()
    n, d = distinct_rows(torch.as_tensor(idx), T, _k3_geometry(2)[0])
    got, n_red = _check_replay(idx, upd, T)
    assert d < 0.5 * n and n_red < 0.5 * n
    assert n_red == k3_reductions(torch.as_tensor(idx), T, _k3_geometry(2)[0])
    np.testing.assert_allclose(got, emb.grad.numpy(), rtol=0, atol=1e-5 * np.abs(got).max())


@pytest.mark.parametrize("C", range(1, 33))
def test_k3_geometry(C):
    S, W = _k3_geometry(C)
    assert S >= 128 and S % 128 == 0  # whole 128-update steps of a warp
    assert W in (1, 2, 4) and C % W == 0
    assert W == max(w for w in (1, 2, 4) if C % w == 0)  # the widest aligned reduction


@pytest.mark.parametrize("chunk", [None, 1, 7, 1000, 4096])
def test_distinct_rows_matches_numpy(chunk):
    rng = np.random.default_rng(11)
    T, M = 5000, 20_000
    idx = rng.integers(0, T, M)
    idx[rng.choice(M, 300, replace=False)] = T  # sentinels
    idx[:40] = -3
    idx[5000:9000] = rng.integers(0, 50, 4000)  # dense duplicates
    keep = (idx >= 0) & (idx < T)
    if chunk is None:
        want = len(np.unique(idx[keep]))
    else:
        pos = np.nonzero(keep)[0]
        want = len(np.unique(np.stack([pos // chunk, idx[keep]], axis=1), axis=0))
    assert distinct_rows(torch.as_tensor(idx, dtype=torch.int32), T, chunk) == (int(keep.sum()), want)


def test_k3_drops_out_of_range_indices():
    idx = torch.tensor([0, 5, 2000, 5, -1, -7], dtype=torch.int64)
    got = segment_add_planes_plain(idx, torch.ones(2, 6), 1000)
    assert got[0, 0] == 1.0 and got[5, 0] == 2.0 and got.sum() == 6.0


@pytest.mark.parametrize("oob_zero", [False, True])
def test_k4_plain_vs_pallas_interpret_and_fallback(oob_zero):
    idx, w, g, TBL = _leveled_case(oob_zero=oob_zero)
    got = factored_segment_add(torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(g), TBL).numpy()
    args = (jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g), TBL)
    pallas = np.asarray(jps._segment_add_factored(*args, block=256, interpret=True))
    fallback = np.asarray(jps.factored_segment_add(*args))
    assert got.shape == (TBL, 16)
    np.testing.assert_allclose(got, pallas, rtol=3e-4, atol=5e-4)
    np.testing.assert_allclose(got, fallback, rtol=1e-5, atol=1e-5)


def test_k4_rounds_weights_to_bf16():
    """Row q*C + c of an update is bf16_rne(w[q]) * g[c] in f32."""
    w = torch.full((8, 1, 1), 1.0 + 2.0**-9)  # a tie: rounds to even (1.0)
    w[1] = 1.0 + 3 * 2.0**-9  # rounds up to 1 + 2^-7
    g = torch.tensor([[[3.0]], [[-1.0]]])
    got = factored_segment_add_plain(torch.zeros(1, 1, dtype=torch.int32), w, g, 2)
    assert got[0, 0] == 3.0 and got[0, 1] == -1.0
    assert got[0, 2] == 3.0 * (1.0 + 2.0**-7) and got[1].abs().sum() == 0


def test_segment_add_other_device_raises():
    with pytest.raises(RuntimeError, match="no kernel"):
        segment_add_planes(torch.zeros(3, dtype=torch.int32, device="meta"),
                           torch.zeros(2, 3, device="meta"), 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        factored_segment_add(torch.zeros(1, 3, dtype=torch.int32, device="meta"),
                             torch.zeros(8, 1, 3, device="meta"), torch.zeros(2, 1, 3, device="meta"), 4)


# ------------------------------------------------------------------ encoder

GRID_CASES = [(4, 10), (5, 11), (6, 12)]


def _cfgs(layout, n_levels, log2):
    # finest scale < 64: one ulp of a cell position stays under 4e-6
    kw = dict(n_levels=n_levels, level_dim=2, base_resolution=8, desired_resolution=64,
              log2_hashmap_size=log2, layout=layout)
    return jhg.HashGridCfg(**kw), thg.HashGridCfg(**kw)


def _inputs(jcfg, seed=0, n=600):
    rng = np.random.default_rng(seed)
    emb = rng.uniform(-1, 1, (jcfg.level_tables()[3], 2)).astype(np.float32)  # an O(1) table
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    x[:40] = rng.uniform(-1.3, 1.3, (40, 3))  # some out of bounds
    x[40:44] = [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, -1.0, 0.0], [0.0, 0.0, 1.0]]
    g = rng.normal(size=(n, jcfg.out_dim)).astype(np.float32)
    return emb, x, g


def test_level_tables_and_shifts_match():
    for layout in thg.LAYOUTS:
        jcfg, tcfg = _cfgs(layout, 16, 22)
        for a, b in zip(jcfg.level_tables(), tcfg.level_tables()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.array(jhg._oct_shifts(jcfg)), thg.oct_shifts(tcfg))
    full = thg.HashGridCfg()
    assert full.level_tables()[3] == 36_112_368 and full.out_dim == 32


@pytest.mark.parametrize("layout", thg.LAYOUTS)
@pytest.mark.parametrize("n_levels,log2", GRID_CASES)
def test_encode_forward_matches_jax(layout, n_levels, log2):
    jcfg, tcfg = _cfgs(layout, n_levels, log2)
    res, sizes, _, _ = tcfg.level_tables()
    assert ((res + 1) ** 3 > sizes).any(), "some levels must be hashed"
    emb, x, _ = _inputs(jcfg)
    want = np.asarray(jhg.hashgrid_encode(jnp.asarray(emb), jnp.asarray(x), jcfg))
    got = thg.hashgrid_encode(torch.as_tensor(emb), torch.as_tensor(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    oob = np.any(np.abs(x) > 1.0, axis=-1)
    assert oob.sum() > 10 and (got[oob] == 0).all()


@pytest.mark.parametrize("layout", thg.LAYOUTS)
@pytest.mark.parametrize("n_levels,log2", GRID_CASES)
def test_encode_vjp_matches_jax(layout, n_levels, log2):
    jcfg, tcfg = _cfgs(layout, n_levels, log2)
    emb, x, g = _inputs(jcfg, seed=1)
    _, vjp = jax.vjp(lambda e, p: jhg.hashgrid_encode(e, p, jcfg), jnp.asarray(emb), jnp.asarray(x))
    de_j, dx_j = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    e = torch.tensor(emb, requires_grad=True)
    p = torch.tensor(x, requires_grad=True)
    thg.hashgrid_encode(e, p, tcfg).backward(torch.as_tensor(g))
    np.testing.assert_allclose(e.grad.numpy(), de_j, atol=1e-5 * np.abs(de_j).max(), rtol=0)
    np.testing.assert_allclose(p.grad.numpy(), dx_j, atol=1e-5 * np.abs(dx_j).max(), rtol=0)
    oob = np.any(np.abs(x) > 1.0, axis=-1)
    assert (p.grad.numpy()[oob] == 0).all()


def test_encode_rejects_unported_layout():
    """Every layout of the JAX package is ported ("quad" included); an
    unknown one raises."""
    assert set(thg.LAYOUTS) == {"oct", "cuda", "quad"}
    with pytest.raises(NotImplementedError, match="hex"):
        thg.hashgrid_encode(torch.zeros(8, 2), torch.zeros(1, 3), thg.HashGridCfg(layout="hex"))


def test_init_hashgrid_range():
    cfg = thg.HashGridCfg(n_levels=4, log2_hashmap_size=10, base_resolution=4, desired_resolution=32)
    t = thg.init_hashgrid(cfg, torch.Generator().manual_seed(0))
    assert t.shape == (cfg.level_tables()[3], 2) and t.dtype == torch.float32
    assert t.abs().max() <= 1e-4 and t.std() > 3e-5


# ------------------------------------------------------------------ quad


def test_quad_shifts_match_the_rolled_table():
    """Row i of the JAX package's rolled quad table holds the four (x, y)
    corners at the port's quad_shifts: gathering them from the bf16 table
    is bit-equal to build_quad_table."""
    jcfg, tcfg = _cfgs("quad", 5, 11)
    emb, _x, _g = _inputs(jcfg)
    quad = np.asarray(jhg.build_quad_table(jnp.asarray(emb), jcfg).astype(jnp.float32))
    _res, sizes, offsets, T = tcfg.level_tables()
    rows = np.arange(T)
    lv = np.searchsorted(offsets, rows, side="right") - 1
    shifts = thg.quad_shifts(tcfg)
    emb16 = torch.as_tensor(emb).to(torch.bfloat16).float().numpy()
    for q in range(4):
        src = (rows - offsets[lv] + shifts[lv, q]) % sizes[lv] + offsets[lv]
        np.testing.assert_array_equal(quad[:, 2 * q : 2 * q + 2], emb16[src])


@pytest.mark.parametrize("n_levels,log2", GRID_CASES)
def test_quad_table_grad_matches_pallas_interpret(n_levels, log2, monkeypatch):
    """The "quad" table gradient (K3's plain version on the (idx, (4C, M))
    stream, then the roll fold) against _qencode_bwd_impl with the Pallas
    K3 in interpret mode: each entry within 2^-15 (+ the fold's f32
    rounding, 2^-21) of the sum of |update| of the four rows folded into
    it. One K3 call on 4C = 8 planes."""
    import functools

    jcfg, tcfg = _cfgs("quad", n_levels, log2)
    emb, x, g = _inputs(jcfg, seed=2)
    T = tcfg.level_tables()[3]
    _out, planes = jhg._qencode_fwd_res(jnp.asarray(emb), jnp.asarray(x), jcfg)
    monkeypatch.setattr(jps, "sorted_segment_add_planes",
                        functools.partial(jps.sorted_segment_add_planes, interpret=True))
    # a fresh jit of the body, so that it is traced with the interpret-mode K3
    # and compiled as the package compiles it (the positions' fused rounding)
    bwd = jax.jit(jhg._qencode_bwd_impl.__wrapped__, static_argnums=(0, 1))
    de_j, _dx = bwd(jcfg, T, jnp.asarray(x), planes, jnp.asarray(g))
    monkeypatch.undo()
    calls = []
    k3 = thg.segment_add_planes

    def grab(idx, upd, table_size):
        calls.append((idx.numpy().copy(), upd.numpy().copy()))
        return k3(idx, upd, table_size)

    monkeypatch.setattr(thg, "segment_add_planes", grab)
    e = torch.tensor(emb, requires_grad=True)
    thg.hashgrid_encode(e, torch.as_tensor(x), tcfg).backward(torch.as_tensor(g))
    assert len(calls) == 1 and calls[0][1].shape == (8, 4 * len(x) * n_levels * 2 // 4)
    idx, upd = calls[0]
    keep = idx < T
    abs_rows = np.zeros((T, 8))
    np.add.at(abs_rows, idx[keep], np.abs(upd[:, keep].T.astype(np.float64)))
    _res, sizes, offsets, _ = tcfg.level_tables()
    shifts = thg.quad_shifts(tcfg)
    folded = np.concatenate([
        sum(np.roll(abs_rows[o : o + s, 2 * q : 2 * q + 2], int(shifts[lv, q]), axis=0) for q in range(4))
        for lv, (o, s) in enumerate(zip(offsets, sizes))])
    d = np.abs(e.grad.numpy() - np.asarray(de_j))
    assert (d <= (2.0**-15 + 2.0**-21) * folded + 1e-30).all(), (d / np.maximum(folded, 1e-30)).max()
    assert np.abs(np.asarray(de_j)).max() > 0
