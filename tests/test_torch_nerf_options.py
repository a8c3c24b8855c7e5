"""Every NerfCfg option of the port's model-free path against
foundationpose_tpu.nerf on the same numpy inputs: the importance sampler,
the near-band subset, the annealed truncation, one train step per option
and with every option on in both grid layouts, the eikonal loss's
second-order hash-grid term, the encoder's gradient of a gradient,
render_frame, DBSCAN, checkpoints and resume, artifact dumps and the
metric sink. JAX runs on the CPU; the port's tensors lie on the CPU, so
K3 / K4 run their plain versions.

The "oct" layout's second-order table term: the JAX package adds the
bf16-rounded corner cotangents in bf16 (its transposed gather, then the
eight rolled corner planes summed from the last to the first); the port
adds the same bf16-rounded cotangents in f32 (K3). `_jax_bf16_term`
replays the JAX package's order and rounding on the port's own stream and
is bit-equal to it; the f32 sum stays within the bf16 accumulation bound
of it (ROADMAP queue 3)."""
import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.nerf import runner as jrun
from foundationpose_tpu.nerf import scene as jscene
from foundationpose_tpu.nerf.config import NerfCfg as JCfg
from foundationpose_tpu.ops import hashgrid as jhash
from foundationpose_torch.models import nerf_params_from_jax
from foundationpose_torch.nerf import runner as trun
from foundationpose_torch.nerf import scene as tscene
from foundationpose_torch.nerf.config import NerfCfg as TCfg
from foundationpose_torch.ops import hashgrid as thash
from foundationpose_torch.ops.segment_add import segment_add_planes_plain
from test_torch_nerf import _box_scene, _flat_grads, _jax_draws, _port_box_scene, _step_cfg

_np = np.asarray
BF16_EPS = 2.0**-8  # bf16's relative spacing: a rounding moves a value by at most half of it


# ---------------------------------------------------------------- samplers


@pytest.mark.parametrize("perturb", [True, False])
def test_sample_pdf_matches_jax(perturb):
    rng = np.random.default_rng(0)
    bins = np.sort(rng.uniform(0.2, 2.0, (40, 17)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (40, 16)).astype(np.float32)
    w[:5] = 0.0  # flat pdfs
    w[5:10, 3] = 50.0  # one dominant bin
    key = jax.random.PRNGKey(3)
    want = _np(jrun.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 12, key, perturb=perturb))
    u = torch.tensor(_np(jax.random.uniform(key, (40, 12)))) if perturb else None
    got = trun.sample_pdf(torch.as_tensor(bins), torch.as_tensor(w), 12, u).numpy()
    # The two pdfs and cumsums add in another order: the cdfs differ by a
    # few ulps (< 16 * 2^-24), and t = (u - cdf_b) / (cdf_a - cdf_b) scales
    # that by 1 / (cdf_a - cdf_b) across the bin: bound each z by it.
    pdf = (w + 1e-5) / (w + 1e-5).sum(-1, keepdims=True)
    cdf = np.concatenate([np.zeros((40, 1)), np.cumsum(pdf, -1)], -1)
    uu = _np(jax.random.uniform(key, (40, 12))) if perturb else np.broadcast_to(np.arange(12) / 11, (40, 12))
    inds = np.stack([np.searchsorted(c, r, side="right") for c, r in zip(cdf, uu)])
    below = np.clip(inds - 1, 0, 15)  # u = 1 past the end: the last bin (where cdf[-1] may round above 1)
    above = below + 1
    step = np.take_along_axis(cdf, above, 1) - np.take_along_axis(cdf, below, 1)
    width = np.take_along_axis(bins, above, 1) - np.take_along_axis(bins, below, 1)
    tol = 1e-6 + 3 * 16 * 2.0**-24 * width / np.maximum(step, 1e-5)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("near_far", [False, True])
def test_subset_near_band_matches_jax(near_far):
    rng = np.random.default_rng(1)
    N, S = 64, 16
    z = np.sort(rng.uniform(0.3, 2.2, (N, S)), axis=-1).astype(np.float32)
    z[:8, 4:12] = z[:8, 4:5]  # ties in the band: the jitter breaks them
    valid = rng.uniform(size=(N, S)) > 0.2
    depth = rng.uniform(0.5, 2.0, N).astype(np.float32)
    depth[::7] = 99.0  # no usable depth: a random subset
    key = jax.random.PRNGKey(4)
    kw = dict(near=0.1, far=2.0) if near_far else {}
    zj, vj = jrun.subset_near_band(jnp.asarray(z), jnp.asarray(valid), jnp.asarray(depth), 0.05, 1.0, 10,
                                   key, **kw)
    u = torch.tensor(_np(jax.random.uniform(key, (N, S))))
    zt, vt = trun.subset_near_band(torch.as_tensor(z), torch.as_tensor(valid), torch.as_tensor(depth),
                                   0.05, 1.0, 10, u, **kw)
    np.testing.assert_array_equal(zt.numpy(), _np(zj))
    np.testing.assert_array_equal(vt.numpy(), _np(vj))


@pytest.mark.parametrize("decay", ["", "linear", "exp"])
def test_truncation_matches_jax(decay):
    kw = dict(n_step=40, trunc=0.01, trunc_start=0.05, trunc_decay_type=decay, sc_factor=7.3)
    jr = types.SimpleNamespace(cfg=JCfg(**kw))
    tr = types.SimpleNamespace(cfg=TCfg(**kw))
    for step in (0, 20, 40, 400):
        want = float(jrun.NerfRunner._truncation(jr, jnp.float32(step)))
        got = trun.NerfRunner.truncation(tr, step)
        assert got == pytest.approx(want, rel=1e-6, abs=0), (decay, step)
    if decay:
        assert trun.NerfRunner.truncation(tr, 0) > trun.NerfRunner.truncation(tr, 40)
    assert trun.NerfRunner.truncation(tr, None) == trun.NerfRunner.truncation(
        types.SimpleNamespace(cfg=TCfg(**dict(kw, trunc_decay_type=""))), 7)


# ---------------------------------------------------- second-order helpers


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _jax_bf16_term(idx, upd, cfg):
    """The JAX package's "oct" second-order table term, replayed on the
    port's K3 stream (idx (M,), upd (C, M) of (point, level, corner) rows in
    order): per oct row (the corner-0 row) and corner, the updates added in
    bf16 in stream order; then per level the eight rolled corner planes
    added in bf16 from corner 7 down to corner 0."""
    res, sizes, offsets, T = cfg.level_tables()
    C = upd.shape[0]
    rows = idx.reshape(-1, cfg.n_levels, 8)
    u = upd.T.reshape(-1, cfg.n_levels, 8, C)
    base = rows[:, :, 0].reshape(-1)
    u = u.reshape(-1, 8, C)
    keep = base < T
    base, u = base[keep], u[keep]
    planes = np.zeros((T, 8, C), np.float32)
    # the k-th update of each base row in the k-th pass: sequential per row
    order = np.argsort(base, kind="stable")
    b_sorted = base[order]
    start = np.searchsorted(b_sorted, b_sorted, side="left")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order)) - start
    for k in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = rank == k
        planes[base[sel]] = _bf16(planes[base[sel]] + u[sel])
    shifts = thash.oct_shifts(cfg)
    out = np.zeros((T, C), np.float32)
    for lv in range(cfg.n_levels):
        o, s = int(offsets[lv]), int(sizes[lv])
        acc = np.roll(planes[o : o + s, 7], int(shifts[lv, 7]), axis=0)
        for q in range(6, -1, -1):
            acc = _bf16(acc + np.roll(planes[o : o + s, q], int(shifts[lv, q]), axis=0))
        out[o : o + s] = acc
    return out


def _bf16_sum_bound(idx, upd, cfg):
    """Per table entry, a bound on |bf16-accumulated - exact| of the oct
    second-order term: every add rounds by at most half a bf16 spacing of
    a partial sum, each partial sum is at most the entry's sum of
    |update|, and an entry sees at most (its updates + 8) adds."""
    T = cfg.level_tables()[3]
    keep = idx < T
    absum = np.zeros((T, upd.shape[0]), np.float32)
    np.add.at(absum, idx[keep], np.abs(upd.T[keep]))
    count = np.bincount(idx[keep], minlength=T)[:, None]
    return (count + 8) * 0.5 * BF16_EPS * absum


def _with_jax_rounding(grid_grad, idx, upd, cfg):
    """The port's "oct" grid gradient with its second-order term (the f32
    sum of the stream, K3's plain version) replaced by the JAX package's
    bf16 sum of the same stream, after holding the two within the bf16
    accumulation bound."""
    f32_term = segment_add_planes_plain(torch.as_tensor(idx), torch.as_tensor(upd), cfg.level_tables()[3]).numpy()
    bf_term = _jax_bf16_term(idx, upd, cfg)
    assert (np.abs(f32_term - bf_term) <= _bf16_sum_bound(idx, upd, cfg)).all()
    return grid_grad - f32_term + bf_term


class _Grab:
    """Records the (idx, upd) stream of every K3 call by the hash grid
    (`k3`), those of the second-order table term among them (`corner`),
    and the number of K4 calls."""

    def __init__(self, monkeypatch):
        self.k3, self.corner, self.k4 = [], [], 0
        k3, k4, corner = thash.segment_add_planes, thash.factored_segment_add, thash.corner_table_grad

        def grab3(idx, upd, table_size):
            self.k3.append((idx.numpy().copy(), upd.numpy().copy()))
            return k3(idx, upd, table_size)

        def grab_corner(idx, upd, table_size):
            self.corner.append((idx.numpy().copy(), upd.numpy().copy()))
            return corner(idx, upd, table_size)

        def grab4(*a):
            self.k4 += 1
            return k4(*a)

        monkeypatch.setattr(thash, "segment_add_planes", grab3)
        monkeypatch.setattr(thash, "corner_table_grad", grab_corner)
        monkeypatch.setattr(thash, "factored_segment_add", grab4)


# ------------------------------------------------------------- train steps


@functools.lru_cache(maxsize=1)
def _scene():
    """test_torch_nerf's box scene and its JAX scene bounds, made once."""
    scene = _box_scene()
    return scene, jscene.compute_scene_bounds(*scene)


def _runners(layout, **kw):
    """test_torch_nerf._runners on the cached box scene: a JAX NerfRunner
    and the port's, the port's parameters loaded from the JAX init."""
    (K, rgbs, depths, masks, cam_in_obs), (sc, tr, pts) = _scene()
    jcfg, tcfg = _step_cfg(layout, **kw)
    norm = dict(sc_factor=sc, translation=tuple(np.asarray(tr).tolist()))
    jcfg, tcfg = dataclasses.replace(jcfg, **norm), dataclasses.replace(tcfg, **norm)
    rn, dn, pn = jscene.preprocess_data(rgbs, depths, masks, cam_in_obs, sc, tr)
    jr = jrun.NerfRunner(jcfg, rn, dn, masks, pn, K, build_pcd=pts)
    tr_ = trun.NerfRunner(tcfg, rn, dn, masks, pn, K, build_pcd=pts, device="cpu")
    tr_.load_params(*nerf_params_from_jax(jax.tree.map(np.asarray, jr.params)))
    return jr, tr_


ALL_OPTIONS = dict(n_importance=8, occ_keep_frac=0.75, trunc_decay_type="linear", trunc_start=0.05,
                   depth_weight=1.0, fs_rgb_weight=0.5, eikonal_weight=0.1)
OPTIONS = {
    "n_importance": dict(n_importance=8),
    "occ_keep_frac": dict(occ_keep_frac=0.75),
    "trunc_linear": dict(trunc_decay_type="linear", trunc_start=0.05),
    "trunc_exp": dict(trunc_decay_type="exp", trunc_start=0.05),
    "depth": dict(depth_weight=1.0),
    "fs_rgb": dict(fs_rgb_weight=0.5),
    "eikonal": dict(eikonal_weight=0.1),
    "all": ALL_OPTIONS,
}
STEP = 3  # the annealed band is between its ends


def _jax_step(jr, key, params=None):
    k2, idx, draws = _jax_draws(jr, key)
    batch = {k: v[idx] for k, v in jr.rays.items()}
    (loss, aux), grads = jax.value_and_grad(jr._loss, has_aux=True)(
        jr.params if params is None else params, batch, k2, jr.occ, jr.c2w, jnp.float32(STEP))
    return float(loss), {k: float(v) for k, v in aux.items()}, _flat_grads(grads), draws


def _port_step(tr, draws, monkeypatch):
    grab = _Grab(monkeypatch)
    loss, aux, grads = tr.loss_and_grads(*draws, step=STEP)
    monkeypatch.undo()
    return float(loss), {k: float(v) for k, v in aux.items()}, {k: v.numpy() for k, v in grads.items()}, grab


def _second_order_stream(tr, grab):
    """The (idx, upd) stream of the eikonal's table term: one K3 call."""
    assert len(grab.corner) == 1, "one K3 call for the second-order table term"
    return grab.corner[0]


def _check_step(jr, tr, option, want, got, grab):
    loss_j, aux_j, gj, _ = want
    loss_t, aux_t, gt = got
    assert loss_t == pytest.approx(loss_j, rel=1e-4), option
    assert set(aux_t) == set(aux_j), (set(aux_t), set(aux_j))
    for k in aux_j:
        assert aux_t[k] == pytest.approx(aux_j[k], rel=1e-4, abs=1e-9), (option, k)
    gt = dict(gt)
    cfg = tr.cfg
    if cfg.eikonal_weight > 0 and cfg.grid_layout == "oct":
        # hold the f32 term within the bf16 accumulation bound of the JAX
        # package's rounding replayed on the same stream, then compare with
        # that rounding in place
        gt["grid"] = _with_jax_rounding(gt["grid"], *_second_order_stream(tr, grab), tr.grid_cfg)
    for k, g in gj.items():
        d = gt[k] - g
        assert np.linalg.norm(d) <= 1e-4 * np.linalg.norm(g) + 1e-30, (option, k, np.linalg.norm(d) / np.linalg.norm(g))
        np.testing.assert_allclose(gt[k], g, atol=1e-3 * np.abs(g).max() + 1e-30, rtol=0, err_msg=f"{option} {k}")
    assert np.abs(gj["grid"]).max() > 0 and np.abs(gj["pose"]).max() > 0


@pytest.mark.parametrize("layout", ["oct", "cuda"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_step_option_matches_jax(layout, option, monkeypatch):
    """One train step at step 3 of 10 with the option on, from the JAX init
    and the JAX draws: loss and every aux term within 1e-4 relative,
    gradients within 1e-4 relative L2 (elementwise 1e-3 of the largest, as
    test_torch_nerf's train-step test). K4 ("oct") or K3 ("cuda") runs once
    a network pass, K3 once more for the eikonal's table term."""
    jr, tr = _runners(layout, **OPTIONS[option])
    want = _jax_step(jr, jax.random.PRNGKey(21))
    got = _port_step(tr, want[3], monkeypatch)
    _check_step(jr, tr, option, want, got[:3], got[3])
    cfg, grab = tr.cfg, got[3]
    passes = 2 if cfg.n_importance > 0 else 1
    eik = 1 if cfg.eikonal_weight > 0 else 0
    assert len(grab.corner) == eik
    if layout == "oct":
        assert (grab.k4, len(grab.k3)) == (passes, eik)
    else:
        assert (grab.k4, len(grab.k3)) == (0, passes + eik)
    if cfg.n_importance > 0:
        out = tr.render_rays({k: v[:16] for k, v in tr.rays.items()}, *(d[:16] for d in tr.draw(16, torch.Generator())[:2]),
                             u_imp=tr.draw(16, torch.Generator())[2], u_tie=tr.draw(16, torch.Generator())[3])
        keep = max(1, round(cfg.n_samples * (cfg.occ_keep_frac or 1.0)))
        assert out["sdf"].shape[-1] == keep + cfg.n_samples_around_depth + cfg.n_importance
        assert (np.diff(out["z_vals"].detach().numpy(), axis=-1) >= 0).all()  # merged z stays sorted


@pytest.mark.parametrize("layout", ["oct", "cuda"])
def test_eikonal_grid_term_matches_jax_and_is_nonzero(layout, monkeypatch):
    """The eikonal loss's table term, the grid gradient with eikonal_weight
    0.1 minus the one with 0 from the same init and draws, against the JAX
    package's: nonzero, a visible share of the grid gradient, and equal to
    JAX's within 1e-4 relative L2 ("oct": with the JAX rounding replayed).
    A port that drops the create-graph path gives zero here."""
    terms = {}
    for eik in (0.0, 0.1):
        jr, tr = _runners(layout, eikonal_weight=eik)
        want = _jax_step(jr, jax.random.PRNGKey(22))
        got = _port_step(tr, want[3], monkeypatch)
        grid_t = got[2]["grid"]
        if eik > 0 and layout == "oct":
            grid_t = _with_jax_rounding(grid_t, *_second_order_stream(tr, got[3]), tr.grid_cfg)
        terms[eik] = (want[2]["grid"], grid_t, got[2]["grid"])
    term_j = terms[0.1][0] - terms[0.0][0]
    term_t = terms[0.1][1] - terms[0.0][1]
    term_f32 = terms[0.1][2] - terms[0.0][2]
    assert np.linalg.norm(term_j) > 0.01 * np.linalg.norm(terms[0.1][0])
    assert np.linalg.norm(term_f32) > 0.01 * np.linalg.norm(terms[0.1][2])
    assert np.linalg.norm(term_t - term_j) <= 1e-4 * np.linalg.norm(terms[0.1][0]), \
        np.linalg.norm(term_t - term_j) / np.linalg.norm(term_j)


@pytest.mark.parametrize("layout,head,table_grad", [
    ("cuda", "tanh", True), ("cuda", "linear", False), ("oct", "linear", True), ("oct", "linear", False)])
def test_encoder_grad_of_grad_matches_jax(layout, head, table_grad, monkeypatch):
    """d/d(table, x) of a function of the encoder's points' gradient
    against jax.grad of a jax.grad. The tanh head's gradient depends on the
    encoding, so the table is also reached through the forward (table_grad
    on). The linear head's does not, so table_grad=False gives the same:
    the NeRF MLP's case (piecewise linear). "oct" runs the linear head only:
    nested under a second jax.grad, the JAX package differentiates its
    encoder's forward itself, whose transposed bf16 gather adds the forward's
    table term in bf16 too, in one sum with the second-order term; with the
    linear head that term is zero, and the JAX rounding of the second-order
    term replayed on the port's stream is bit-equal to JAX's."""
    cfg = dict(n_levels=3, level_dim=2, base_resolution=4, desired_resolution=16, log2_hashmap_size=8,
               layout=layout)
    jc, tc = jhash.HashGridCfg(**cfg), thash.HashGridCfg(**cfg)
    rng = np.random.default_rng(5)
    T = tc.level_tables()[3]
    emb = rng.normal(size=(T, 2)).astype(np.float32)
    x = rng.uniform(-1.05, 1.05, (200, 3)).astype(np.float32)  # a few outside the box
    W = rng.normal(size=(tc.out_dim,)).astype(np.float32)
    V = rng.normal(size=(200, 3)).astype(np.float32)
    act = jnp.tanh if head == "tanh" else (lambda a: a)
    tact = torch.tanh if head == "tanh" else (lambda a: a)

    def f(e, xx):
        n = jax.grad(lambda p: jnp.sum(act(jhash.hashgrid_encode(e, p, jc) @ W)))(xx)
        return jnp.sum(n * V) + jnp.sum(n**2)

    ge, gx = jax.grad(f, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(x))
    grab = _Grab(monkeypatch)
    et, xt = torch.tensor(emb, requires_grad=True), torch.tensor(x, requires_grad=True)
    s = tact(thash.hashgrid_encode(et, xt, tc, table_grad=table_grad) @ torch.as_tensor(W)).sum()
    n, = torch.autograd.grad(s, xt, create_graph=True)
    (torch.sum(n * torch.as_tensor(V)) + torch.sum(n**2)).backward()
    monkeypatch.undo()
    ge, gx, got_e = _np(ge), _np(gx), et.grad.numpy()
    np.testing.assert_allclose(xt.grad.numpy(), gx, atol=2e-6 * np.abs(gx).max(), rtol=0)
    # table_grad on: the first-order table gradient once for the inner
    # autograd.grad (which asks only for x), and with the tanh head once
    # more for the outer backward
    first = (2 if head == "tanh" else 1) if table_grad else 0
    assert (len(grab.k3), grab.k4) == ((1, first) if layout == "oct" else (1 + first, 0))
    assert len(grab.corner) == 1
    if layout == "oct":
        got_e = _with_jax_rounding(got_e, *grab.corner[0], tc)
    np.testing.assert_allclose(got_e, ge, atol=2e-6 * np.abs(ge).max(), rtol=0)
    assert np.abs(ge).max() > 0


def test_zero_normals_give_finite_gradients_where_jax_gives_nan(monkeypatch):
    """A zero table gives zero normals at every sample. jnp.linalg.norm's
    gradient there is NaN, so the JAX package's eikonal step returns NaN
    gradients (a fault of the JAX package, ROADMAP queue 3); the port's
    vector_norm gives 0, so its gradients are the eikonal-off step's."""
    out = {}
    for eik in (0.0, 0.1):
        jr, tr = _runners("oct", eikonal_weight=eik)
        params = jax.tree.map(np.array, jr.params)
        params["grid"][:] = 0.0
        jr.params = jax.tree.map(jnp.asarray, params)
        tr.load_params(*nerf_params_from_jax(params))
        want = _jax_step(jr, jax.random.PRNGKey(23))
        out[eik] = (want, _port_step(tr, want[3], monkeypatch))
    assert any(np.isnan(g).any() for g in out[0.1][0][2].values())
    got_on, got_off = out[0.1][1], out[0.0][1]
    assert got_on[1]["eikonal_loss"] == pytest.approx(0.1, rel=1e-6)
    for k, g in got_off[2].items():
        assert np.isfinite(got_on[2][k]).all(), k
        np.testing.assert_allclose(got_on[2][k], g, atol=1e-7 * max(np.abs(g).max(), 1e-30), rtol=0, err_msg=k)


# ------------------------------------------------------------ render_frame


def test_render_frame_matches_jax():
    """perturb=False render of frame 0 in chunks of 1024 rays, near-band
    subset and importance on, from an O(1) table (the SDF crosses zero):
    the JAX package's draws (PRNGKey(0) per chunk) pinned."""
    jr, tr = _runners("oct", n_importance=8, occ_keep_frac=0.75)
    rng = np.random.default_rng(9)
    params = jax.tree.map(np.array, jr.params)
    params["grid"] = rng.uniform(-1, 1, params["grid"].shape).astype(np.float32)
    params["mlp"]["sigma"][-1]["bias"][0] = 0.0
    jr.params = jax.tree.map(jnp.asarray, params)
    tr.load_params(*nerf_params_from_jax(params))
    cfg, chunk = jr.cfg, 1024
    n = int((_np(jr.rays["frame_id"]) == 0).sum())
    k1, _, _, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    u_occ, u_tie = [], []
    for s0 in range(0, n, chunk):
        rows = min(chunk, n - s0)
        shape = rows + (-rows) % 256  # the JAX package pads a chunk to 256 rays
        u_occ.append(_np(jax.random.uniform(jax.random.split(k1)[1], (shape, cfg.candidate_mult * cfg.n_samples)))[:rows])
        u_tie.append(_np(jax.random.uniform(k4, (shape, cfg.n_samples)))[:rows])
    rgb_j, depth_j = jr.render_frame(0, chunk=chunk)
    rgb_t, depth_t = tr.render_frame(0, chunk=chunk, draws=(torch.as_tensor(np.concatenate(u_occ)),
                                                            torch.as_tensor(np.concatenate(u_tie))))
    assert rgb_t.shape == rgb_j.shape and depth_t.shape == depth_j.shape
    np.testing.assert_allclose(rgb_t, rgb_j, atol=2e-5, rtol=0)
    np.testing.assert_allclose(depth_t, depth_j, atol=2e-5, rtol=0)
    hit = (depth_j > 0) & (depth_j < cfg.far * cfg.sc_factor)
    assert hit.mean() > 0.05 and rgb_j.max() > 0


# ------------------------------------------------------------------ DBSCAN


@pytest.mark.parametrize("min_samples", [1, 2, 3, 4, 5])
def test_dbscan_labels_match_sklearn(min_samples):
    """Dense blobs, a chain of border points between two of them, sparse
    singletons (noise for min_samples > 1)."""
    from sklearn.cluster import DBSCAN

    rng = np.random.default_rng(min_samples)
    pts = np.concatenate([
        rng.normal(0, 0.006, (300, 3)),
        rng.normal(0.08, 0.004, (120, 3)),
        np.linspace([0.02, 0, 0], [0.06, 0.08, 0.08], 25) + rng.normal(0, 0.001, (25, 3)),
        rng.uniform(-0.3, 0.3, (80, 3)),
    ])
    pts = pts[rng.permutation(len(pts))]
    want = DBSCAN(eps=0.01, min_samples=min_samples).fit(pts).labels_
    got = tscene.dbscan_labels(pts, 0.01, min_samples)
    np.testing.assert_array_equal(got, want)
    if min_samples > 1:
        assert (want == -1).any()
        nb = np.array([(np.linalg.norm(pts - p, axis=1) <= 0.01).sum() for p in pts])
        assert ((want >= 0) & (nb < min_samples)).any() or min_samples == 2  # border points


# ------------------------------------------- checkpoints, artifacts, sink

RUN_CFG = dict(n_step=4, n_rand=128, n_samples=16, n_samples_around_depth=16, num_levels=4, finest_res=64,
               log2_hashmap_size=12, amp=False, mesh_resolution=0.02)


@functools.lru_cache(maxsize=1)
def _port_scene():
    return _port_box_scene()


def _port_runner(**kw):
    K, rgbs, depths, masks, cam_in_obs = _port_scene()
    cfg = TCfg(**dict(RUN_CFG, **kw))
    sc, tr, pts = tscene.compute_scene_bounds(K, rgbs, depths, masks, cam_in_obs)
    cfg = dataclasses.replace(cfg, sc_factor=sc, translation=tuple(np.asarray(tr).tolist()))
    rn, dn, pn = tscene.preprocess_data(rgbs, depths, masks, cam_in_obs, sc, tr)
    return trun.NerfRunner(cfg, rn, dn, masks, pn, K, build_pcd=pts, device="cpu")


@pytest.mark.parametrize("options", ["default", "all"])
def test_save_resume_bit_equal(tmp_path, options):
    """train(ckpt_dir=, i_weights=2) saves after steps 2 and 4 (step_0000003,
    step_0000005); a fresh runner resumed from step 3 ends bit-equal to the
    uninterrupted run, parameters and optimizer state."""
    kw = ALL_OPTIONS if options == "all" else {}
    ck = str(tmp_path / "ck")
    full = _port_runner(**kw)
    full.train(seed=3, ckpt_dir=ck, i_weights=2)
    assert sorted(os.listdir(ck)) == ["step_0000003", "step_0000005"]
    resumed = _port_runner(**kw)
    resumed.resume(ck, step=3)
    assert resumed.global_step == 3 and resumed.opt["count"] == 3
    resumed.train(seed=3)
    assert resumed.global_step == full.global_step == 5
    for (name, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for m in ("mu", "nu"):
        for name, a in full.opt[m].items():
            assert torch.equal(a, resumed.opt[m][name]), (m, name)
    latest = _port_runner(**kw)
    latest.resume(ck)
    assert latest.global_step == 5
    assert all(torch.equal(a, b) for a, b in zip(full.model.state_dict().values(),
                                                  latest.model.state_dict().values()))


def test_artifacts_and_metric_sink(tmp_path):
    """tests/test_nerf.py::TestArtifactDumps on the port: image and pose
    dumps at their cadence, the mesh directory only when a mesh exists,
    and the metric sink at the logging cadence with every loss term."""
    runner = _port_runner(depth_weight=1.0, eikonal_weight=0.1)
    art = str(tmp_path / "artifacts")
    sunk = []
    runner.train(artifact_dir=art, i_img=2, i_mesh=4, i_pose=2,
                 metric_sink=lambda step, scalars: sunk.append((step, scalars)))
    imgs = os.listdir(f"{art}/image")
    assert sorted(imgs) == ["step_0000002.png", "step_0000004.png"]
    from foundationpose_torch.utils.vis import read_rgb

    img = read_rgb(f"{art}/image/step_0000002.png")
    assert img.shape == (runner.H, 2 * runner.W, 3) and img.dtype == np.uint8
    if os.path.isdir(f"{art}/mesh"):
        assert any(f.endswith(".obj") for f in os.listdir(f"{art}/mesh"))
    assert sorted(os.listdir(f"{art}/pose")) == ["step_0000002.npy", "step_0000004.npy"]
    dumped = np.load(f"{art}/pose/step_0000004.npy")
    np.testing.assert_allclose(dumped, runner.get_optimized_poses_in_real_world(), atol=0, rtol=0)
    assert [s for s, _ in sunk] == [0, 1, 2, 3, 4]  # every tenth of 5 steps
    keys = {"loss", "rgb_loss", "fs_loss", "empty_loss", "sdf_loss", "depth_loss", "eikonal_loss"}
    assert all(set(s) == keys and all(np.isfinite(list(s.values()))) for _, s in sunk)
