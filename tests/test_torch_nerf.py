"""The model-free path of foundationpose_torch (neural object field)
against foundationpose_tpu.nerf on the same numpy inputs: model pieces,
occupancy sampling, scene bounds, ray building, the optimizer, one train
step from two states for both grid layouts, extraction, the texture bake,
and an end-to-end run. JAX runs on the CPU; the port's tensors lie on the
CPU, so K3 / K4 run their plain versions.
"""
import dataclasses
import inspect
import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from foundationpose_tpu.nerf import model as jmodel
from foundationpose_tpu.nerf import occupancy as jocc
from foundationpose_tpu.nerf import runner as jrun
from foundationpose_tpu.nerf import scene as jscene
from foundationpose_tpu.nerf.config import NerfCfg as JCfg
from foundationpose_torch.models import nerf_params_from_jax
from foundationpose_torch.nerf import model as tmodel
from foundationpose_torch.nerf import occupancy as tocc
from foundationpose_torch.nerf import runner as trun
from foundationpose_torch.nerf import scene as tscene
from foundationpose_torch.nerf.config import NerfCfg as TCfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(a):
    return np.asarray(a)


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(degree):
    d = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = _np(jmodel.sh_encode(jnp.asarray(d), degree))
    got = tmodel.sh_encode(torch.as_tensor(d), degree).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_pose_array_matrices():
    data = np.random.default_rng(1).normal(size=(6, 6)).astype(np.float32)
    data[2] = 0.0  # the small-angle branch
    want = _np(jmodel.pose_array_matrices(jnp.asarray(data), 0.2, 10.0))
    got = tmodel.pose_array_matrices(torch.as_tensor(data), 0.2, 10.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[0], np.eye(4))


def _mlp_pair(seed=0, input_ch=8, views=11):
    jp = jmodel.init_nerf_mlp(jax.random.PRNGKey(seed), input_ch, views)
    mlp = tmodel.NerfMLP(input_ch, views)
    sd, _ = nerf_params_from_jax(
        {"grid": np.zeros((1, 2)), "mlp": jp, "features": np.zeros((1, 2)), "pose": np.zeros((1, 6))}
    )
    mlp.load_state_dict({k[4:]: v for k, v in sd.items() if k.startswith("mlp.")})
    return jp, mlp


def test_mlp_f32():
    jp, mlp = _mlp_pair()
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(4, 33, 8)).astype(np.float32)
    views = rng.normal(size=(4, 33, 11)).astype(np.float32)
    want = _np(jmodel.apply_nerf_mlp(jp, jnp.asarray(emb), jnp.asarray(views)))
    got = mlp(torch.as_tensor(emb), torch.as_tensor(views)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    want_sdf = _np(jmodel.apply_nerf_sdf(jp, jnp.asarray(emb)))
    np.testing.assert_allclose(mlp.sdf(torch.as_tensor(emb)).detach().numpy(), want_sdf, atol=1e-5, rtol=1e-5)


def test_mlp_bf16_layer_by_layer():
    """Each layer from the same bf16 input: the JAX layer (bf16 x bf16
    product, f32 accumulate + bias, one rounding) and the port's agree
    to one bf16 ulp (the f32 sums run in another order), mostly exactly."""
    jp, mlp = _mlp_pair(seed=3)
    rng = np.random.default_rng(4)
    layers = [("sigma", 0, 8), ("sigma", 1, 64), ("color", 0, 26), ("color", 1, 64), ("color", 2, 64)]
    for head, i, fan_in in layers:
        x = jnp.asarray(rng.normal(size=(512, fan_in)).astype(np.float32)).astype(jnp.bfloat16)
        p = jp[head][i]
        want = _np(
            (jnp.dot(x, p["kernel"].astype(jnp.bfloat16), preferred_element_type=jnp.float32)
             + p["bias"]).astype(jnp.bfloat16).astype(jnp.float32)
        )
        xt = torch.as_tensor(_np(x.astype(jnp.float32))).to(torch.bfloat16)
        got = tmodel._lin(getattr(mlp, head)[i], xt, torch.bfloat16).float().detach().numpy()
        ulp = 2.0**-7 * np.abs(want)
        assert (np.abs(got - want) <= ulp + 1e-30).all(), (head, i)
        assert (got == want).mean() > 0.97, (head, i)
    emb = rng.normal(size=(64, 8)).astype(np.float32)
    views = rng.normal(size=(64, 11)).astype(np.float32)
    want = _np(jmodel.apply_nerf_mlp(jp, jnp.asarray(emb), jnp.asarray(views), dtype=jnp.bfloat16))
    got = mlp(torch.as_tensor(emb), torch.as_tensor(views), torch.bfloat16).detach().numpy()
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.02)


# -------------------------------------------------------------- occupancy


def _occ_grid(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, (3000, 3))
    pts[:, 2] = rng.uniform(-0.1, 0.1, 3000)
    return jocc.build_occupancy_grid(pts, 0.05, dilate=1)


def _rays(seed=1, n=64):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    o[:, 2] = -1.6
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    d[:, 2] = 1.0
    o[:4] = [[5.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.9, 0.9, -2.0], [0.0, 0.3, -1.5]]
    return o, d


def test_occupancy_grid_lookup_and_ray_box():
    occ = _occ_grid()
    np.testing.assert_array_equal(tocc.build_occupancy_grid(np.eye(3) * 0.3, 0.1, 2),
                                  jocc.build_occupancy_grid(np.eye(3) * 0.3, 0.1, 2))
    pts = np.random.default_rng(2).uniform(-1.2, 1.2, (2000, 3)).astype(np.float32)
    want = _np(jocc.occupancy_lookup(jnp.asarray(occ), jnp.asarray(pts)))
    got = tocc.occupancy_lookup(torch.as_tensor(occ), torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    o, d = _rays()
    for a, b in zip(jocc.ray_box_intersection(jnp.asarray(o), jnp.asarray(d)),
                    tocc.ray_box_intersection(torch.as_tensor(o), torch.as_tensor(d))):
        np.testing.assert_allclose(b.numpy(), _np(a), atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_depth", [False, True])
def test_sample_occupied_pinned_uniforms(with_depth):
    occ = _occ_grid()
    o, d = _rays()
    n, mult = 16, 4
    key = jax.random.PRNGKey(7)
    u = _np(jax.random.uniform(jax.random.split(key)[1], (len(o), n * mult)))  # occupancy.py:108
    kw = {}
    if with_depth:
        depth = np.random.default_rng(3).uniform(1.0, 2.5, len(o)).astype(np.float32)
        depth[::5] = 99.0
        kw = dict(trunc=0.05, far_clip=2.0)
    zj, vj = jocc.sample_occupied(jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d), key, n,
                                  depth=jnp.asarray(depth) if with_depth else None, candidate_mult=mult, **kw)
    zt, vt = tocc.sample_occupied(torch.as_tensor(occ), torch.as_tensor(o), torch.as_tensor(d), n,
                                  u=torch.as_tensor(u), depth=torch.as_tensor(depth) if with_depth else None,
                                  candidate_mult=mult, **kw)
    np.testing.assert_array_equal(vt.numpy(), _np(vj))
    assert vt.numpy().sum() > len(o) * n // 4
    np.testing.assert_allclose(zt.numpy(), _np(zj), atol=1e-5, rtol=1e-6)


# ---------------------------------------------------------- scene, rays


def _box_scene(hw=64, f=60.0, n_views=4):
    """tests/test_nerf.py's box scene: a 0.2 m box seen from 42 views at
    0.6 m, rendered by the JAX package."""
    from foundationpose_tpu.geometry.icosphere import sample_views_icosphere
    from foundationpose_tpu.meshio import make_box
    from foundationpose_tpu.ops import render_mesh

    box = make_box(np.array([0.2, 0.2, 0.2]))
    box.vertex_colors = np.random.default_rng(0).integers(50, 255, (8, 3)).astype(np.uint8)
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1.0]], np.float32)
    cam_in_obs = sample_views_icosphere(n_views=n_views)
    cam_in_obs[:, :3, 3] *= 0.6
    out = render_mesh(
        jnp.asarray(box.vertices.astype(np.float32)), jnp.asarray(box.faces.astype(np.int32)),
        jnp.asarray(np.linalg.inv(cam_in_obs).astype(np.float32)), jnp.asarray(K), out_hw=(hw, hw),
        vertex_color=jnp.asarray(box.vertex_colors.astype(np.float32) / 255),
        vnormals=jnp.asarray(box.vertex_normals.astype(np.float32)), use_light=True,
        pose_block=len(cam_in_obs),
    )
    rgbs = (_np(out.color) * 255).astype(np.uint8)
    return K, rgbs, _np(out.depth).astype(np.float32), _np(out.mask).astype(np.uint8), cam_in_obs


def test_scene_bounds_box_scene():
    K, rgbs, depths, masks, cam_in_obs = _box_scene()
    sj, tj, pj = jscene.compute_scene_bounds(K, rgbs, depths, masks, cam_in_obs)
    st, tt, pt = tscene.compute_scene_bounds(K, rgbs, depths, masks, cam_in_obs)
    assert st == sj
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(pt, pj)


def test_dbscan_labels_match_sklearn_on_clusters():
    from sklearn.cluster import DBSCAN

    rng = np.random.default_rng(5)
    pts = np.concatenate([
        rng.normal(0, 0.01, (400, 3)),
        rng.normal(0.2, 0.004, (150, 3)),
        rng.normal(-0.2, 0.004, (150, 3)),  # a tie in size with the one above
        rng.uniform(-0.5, 0.5, (30, 3)),  # scattered singletons
    ])
    pts = pts[rng.permutation(len(pts))]
    want = DBSCAN(eps=0.01, min_samples=1).fit(pts).labels_
    got = tscene.dbscan_labels(pts, 0.01)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 5
    want2 = DBSCAN(eps=0.01, min_samples=2).fit(pts).labels_
    got2 = tscene.dbscan_labels(pts, 0.01, min_samples=2)
    np.testing.assert_array_equal(got2, want2)
    assert (got2 == -1).any()  # the scattered singletons are noise at min_samples 2


def test_scene_bounds_with_stray_clusters():
    """Depth with a second, smaller blob and speckle: the biggest cluster
    and the normalization agree with the sklearn-based function."""
    K, rgbs, depths, masks, cam_in_obs = _box_scene()
    depths, masks = depths.copy(), masks.copy()
    depths[:, 2:8, 2:8] = 0.35  # a stray blob in front of the box
    masks[:, 2:8, 2:8] = 1
    rng = np.random.default_rng(6)
    sel = rng.uniform(size=depths.shape) < 0.01
    depths[sel] = rng.uniform(0.2, 1.0, sel.sum())
    masks[sel] = 1
    sj, tj, pj = jscene.compute_scene_bounds(K, rgbs, depths, masks, cam_in_obs)
    st, tt, pt = tscene.compute_scene_bounds(K, rgbs, depths, masks, cam_in_obs)
    assert st == sj
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(pt, pj)


@pytest.mark.parametrize("dilate", [100, 5, 4, 0])
def test_make_frame_rays_bit_equal(dilate):
    rng = np.random.default_rng(dilate)
    H, W = 120, 160
    mask = np.zeros((H, W), np.uint8)
    mask[40:70, 50:90] = 1
    mask[rng.uniform(size=(H, W)) < 0.002] = 1
    mask[0, 0] = mask[H - 1, W - 5] = 1
    rgb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 99, (H, W)).astype(np.float32)
    K = np.array([[200.0, 0, 81.5], [0, 210.0, 59.0], [0, 0, 1]])
    want = jrun.make_frame_rays(rgb, depth, mask, K, 3, dilate=dilate)
    got = trun.make_frame_rays(rgb, depth, mask, K, 3, dilate=dilate)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


# -------------------------------------------------------------- optimizer


def test_optimizer_matches_optax():
    import optax

    cfg = TCfg(n_step=7)
    rng = np.random.default_rng(8)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    schedule = optax.exponential_decay(cfg.lrate, transition_steps=cfg.n_step, decay_rate=cfg.decay_rate)
    tx = optax.chain(optax.clip_by_global_norm(cfg.gradient_max_norm), optax.scale_by_adam(eps=1e-15),
                     optax.scale_by_learning_rate(schedule))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = trun.init_opt_state(tp)
    for step, scale in enumerate((0.01, 3.0, 1e-6)):  # below and above the clip norm, and tiny
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32) for k, v in params.items()}
        grads["a"][0, 0] = 0.0
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        trun.apply_gradients(tp, {k: torch.as_tensor(v) for k, v in grads.items()}, opt, cfg)
        assert opt["count"] == step + 1
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]), atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(opt["mu"][k].numpy(), _np(state[1].mu[k]), atol=1e-9, rtol=1e-5)
            np.testing.assert_allclose(opt["nu"][k].numpy(), _np(state[1].nu[k]), atol=1e-12, rtol=1e-5)


# ------------------------------------------------------------ train step


def _step_cfg(layout, **kw):
    base = dict(n_step=10, n_rand=64, n_samples=8, n_samples_around_depth=8, num_levels=4, finest_res=64,
                log2_hashmap_size=12, amp=False, grid_layout=layout)
    base.update(kw)
    return JCfg(**base), TCfg(**base)


def _runners(layout, **kw):
    """A JAX NerfRunner and the port's on the same preprocessed box scene,
    the port's parameters loaded from the JAX init."""
    K, rgbs, depths, masks, cam_in_obs = _box_scene()
    jcfg, tcfg = _step_cfg(layout, **kw)
    sc, tr, pts = jscene.compute_scene_bounds(K, rgbs, depths, masks, cam_in_obs)
    norm = dict(sc_factor=sc, translation=tuple(np.asarray(tr).tolist()))
    jcfg, tcfg = dataclasses.replace(jcfg, **norm), dataclasses.replace(tcfg, **norm)
    rn, dn, pn = jscene.preprocess_data(rgbs, depths, masks, cam_in_obs, sc, tr)
    jr = jrun.NerfRunner(jcfg, rn, dn, masks, pn, K, build_pcd=pts)
    tr_ = trun.NerfRunner(tcfg, rn, dn, masks, pn, K, build_pcd=pts, device="cpu")
    for k in jr.rays:
        np.testing.assert_array_equal(tr_.rays[k].numpy(), _np(jr.rays[k]))
    np.testing.assert_array_equal(tr_.occ.numpy(), _np(jr.occ))
    tr_.load_params(*nerf_params_from_jax(jax.tree.map(np.asarray, jr.params)))
    return jr, tr_


def _jax_draws(jr, key):
    """The draws of NerfRunner._make_train_step for `key` (runner.py:529-536,
    :291, occupancy.py:108, sample_pdf :64, subset_near_band :100): batch
    indices, occupancy, around-depth, importance and near-band tie
    uniforms, the last two None where their option is off."""
    cfg = jr.cfg
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (cfg.n_rand,), 0, jr.n_rays)
    kr1, kr2, kr3, kr4 = jax.random.split(k2, 4)
    u_occ = jax.random.uniform(jax.random.split(kr1)[1], (cfg.n_rand, cfg.candidate_mult * cfg.n_samples))
    u_depth = jax.random.uniform(kr2, (cfg.n_rand, cfg.n_samples_around_depth))
    u_imp = jax.random.uniform(kr3, (cfg.n_rand, cfg.n_importance)) if cfg.n_importance > 0 else None
    subsets = cfg.occ_keep_frac is not None and cfg.occ_keep_frac < 1.0
    u_tie = jax.random.uniform(kr4, (cfg.n_rand, cfg.n_samples)) if subsets else None
    return k2, idx, [None if a is None else torch.as_tensor(_np(a)) for a in (idx, u_occ, u_depth, u_imp, u_tie)]


def _flat_grads(tree):
    sd, _ = nerf_params_from_jax(jax.tree.map(np.asarray, tree))
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("layout", ["oct", "cuda", "quad"])
@pytest.mark.parametrize("start", ["fresh", "after_3_steps"])
def test_train_step_matches_jax(layout, start):
    jr, tr = _runners(layout)
    params, opt_state = jr.params, jr.opt_state
    if start == "after_3_steps":
        for i in range(3):
            params, opt_state, _, _ = jr._train_step(params, opt_state, jax.random.PRNGKey(100 + i))
        tr.load_params(*nerf_params_from_jax(jax.tree.map(np.asarray, params),
                                             jax.tree.map(np.asarray, opt_state)))
    key = jax.random.PRNGKey(11)
    k2, idx, draws = _jax_draws(jr, key)
    batch = {k: v[idx] for k, v in jr.rays.items()}
    (loss_j, aux_j), grads_j = jax.value_and_grad(jr._loss, has_aux=True)(
        params, batch, k2, jr.occ, jr.c2w, jnp.float32(0))
    new_j, _, loss_j2, _ = jr._train_step(params, opt_state, key)
    assert float(loss_j2) == pytest.approx(float(loss_j), rel=1e-6)

    loss_t, aux_t, grads_t = tr.loss_and_grads(*draws)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
    for k in aux_j:
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=1e-4, abs=1e-9), k
    gj = _flat_grads(grads_j)
    for k, g in gj.items():
        # Within 1e-4 relative (L2 per parameter). Elementwise within 1e-3
        # of the largest entry: the compiled JAX graph fuses some
        # multiply-adds of the sample positions, so a trilinear weight
        # next to a bf16 rounding tie (K4 rounds weights to bf16) can land
        # one bf16 ulp away in a few table entries.
        d = grads_t[k].numpy() - g
        assert np.linalg.norm(d) <= 1e-4 * np.linalg.norm(g) + 1e-30, k
        np.testing.assert_allclose(grads_t[k].numpy(), g, atol=1e-3 * np.abs(g).max() + 1e-30, rtol=0,
                                   err_msg=k)
    assert np.abs(gj["grid"]).max() > 0 and np.abs(gj["pose"]).max() > 0

    tr.apply_gradients(grads_t)
    pj = _flat_grads(new_j)
    tp = dict(tr.model.state_dict())
    for k, p in pj.items():
        # Adam's first steps move each entry by about +-lr by the sign of
        # its gradient: compare where the gradient is clearly nonzero
        sel = np.abs(gj[k]) > 1e-6 * np.abs(gj[k]).max()
        # to 1e-4 relative, or 1e-3 of a learning-rate step where the
        # gradient (known to 1e-4 of its largest entry) is small
        np.testing.assert_allclose(tp[k].numpy()[sel], p[sel], atol=1e-3 * jr.cfg.lrate, rtol=1e-4,
                                   err_msg=k)


def test_unported_options_raise():
    """Every option of NerfCfg is ported, the "quad" grid layout included;
    only a layout neither package has raises."""
    with pytest.raises(NotImplementedError, match="hex"):
        trun.check_supported(TCfg(grid_layout="hex"))
    for kw in (dict(), dict(n_importance=4), dict(eikonal_weight=0.1), dict(depth_weight=1.0),
               dict(fs_rgb_weight=0.5), dict(occ_keep_frac=0.75), dict(trunc_decay_type="linear"),
               dict(trunc_decay_type="exp"), dict(grid_layout="cuda"), dict(grid_layout="quad"),
               dict(dbscan_min_samples=3)):
        trun.check_supported(TCfg(**kw))


# ------------------------------------------------- extraction and texture


def test_query_sdf_grid_and_extract_mesh_match_jax():
    """From the same parameters (an O(1) table so the SDF crosses zero)."""
    jr, tr = _runners("oct", mesh_resolution=0.02)
    rng = np.random.default_rng(9)
    params = jax.tree.map(np.array, jr.params)
    params["grid"] = rng.uniform(-1, 1, params["grid"].shape).astype(np.float32)
    params["mlp"]["sigma"][-1]["bias"][0] = 0.0
    jr.params = jax.tree.map(jnp.asarray, params)
    tr.load_params(*nerf_params_from_jax(params))
    sdf_j, coords_j = jr.query_sdf_grid()
    sdf_t, coords_t = tr.query_sdf_grid()
    np.testing.assert_array_equal(coords_t, coords_j)
    np.testing.assert_allclose(sdf_t, sdf_j, atol=1e-5, rtol=0)
    # no grid value closer to the iso level than the two differ: the same triangulation
    assert np.abs(sdf_j).min() > 2 * np.abs(sdf_t - sdf_j).max()
    mj, mt = jr.extract_mesh(), tr.extract_mesh()
    assert len(mj.faces) > 100
    # the same triangles; vertex welding (a rounded key) may number them apart
    assert mt.faces.shape == mj.faces.shape
    np.testing.assert_allclose(mt.vertices[mt.faces], mj.vertices[mj.faces], atol=1e-4, rtol=0)
    wt, wj = tr.mesh_to_real_world(mt), jr.mesh_to_real_world(mj)
    np.testing.assert_allclose(wt.vertices[wt.faces], wj.vertices[wj.faces], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr.get_optimized_poses_in_real_world(),
                               jr.get_optimized_poses_in_real_world(), atol=1e-6, rtol=0)


def test_bake_texture_matches_jax():
    """A 320-face mesh (<= 1536: the JAX bake renders with 'brute') seen
    from 42 views; texture within 1 on uint8."""
    from foundationpose_tpu.geometry.icosphere import icosphere, sample_views_icosphere
    from foundationpose_tpu.meshio import TriMesh
    from foundationpose_tpu.nerf.texture import bake_texture as j_bake
    from foundationpose_torch.nerf.texture import bake_texture as t_bake

    verts, faces = icosphere(2, radius=0.1)
    rng = np.random.default_rng(10)
    mesh = TriMesh(vertices=verts * (1 + 0.1 * rng.uniform(size=(len(verts), 1))), faces=faces)
    K = np.array([[140.0, 0, 48.0], [0, 140.0, 48.0], [0, 0, 1.0]], np.float32)
    cam_in_obs = sample_views_icosphere(n_views=4)
    cam_in_obs[:, :3, 3] *= 0.5
    rgbs = rng.integers(0, 255, (len(cam_in_obs), 96, 96, 3)).astype(np.uint8)
    depths = rng.uniform(0.3, 0.6, (len(cam_in_obs), 96, 96)).astype(np.float32)
    for top in (4, 1):
        bj = j_bake(mesh, rgbs, depths, cam_in_obs, K, tex_res=128, top_views=top)
        bt = t_bake(mesh, rgbs, depths, cam_in_obs, K, tex_res=128, top_views=top, device="cpu")
        assert bt.texture.shape == (128, 128, 3)
        np.testing.assert_array_equal(bt.faces, bj.faces)
        np.testing.assert_allclose(bt.uv, bj.uv, atol=0, rtol=0)
        np.testing.assert_allclose(bt.vertices, bj.vertices, atol=0, rtol=0)
        diff = np.abs(bt.texture.astype(int) - bj.texture.astype(int))
        assert diff.max() <= 1, diff.max()


# ------------------------------------------------------------- end to end


def _port_box_scene(hw=64, f=60.0):
    """The box scene rendered by the port (no JAX)."""
    from foundationpose_torch.geometry.icosphere import sample_views_icosphere
    from foundationpose_torch.meshio import make_box
    from foundationpose_torch.ops import render_mesh

    box = make_box(np.array([0.2, 0.2, 0.2]))
    box.vertex_colors = np.random.default_rng(0).integers(50, 255, (8, 3)).astype(np.uint8)
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1.0]], np.float32)
    cam_in_obs = sample_views_icosphere(n_views=4)
    cam_in_obs[:, :3, 3] *= 0.6
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    out = render_mesh(T(box.vertices), torch.as_tensor(box.faces), T(np.linalg.inv(cam_in_obs)), T(K),
                      out_hw=(hw, hw), vertex_color=T(box.vertex_colors / 255.0),
                      vnormals=T(box.vertex_normals), use_light=True)
    rgbs = (out.color.numpy() * 255).astype(np.uint8)
    return K, rgbs, out.depth.numpy(), out.mask.numpy().astype(np.uint8), cam_in_obs


E2E_CFG = dict(n_step=60, n_rand=256, n_samples=16, n_samples_around_depth=16, num_levels=8, finest_res=128,
               log2_hashmap_size=15, mesh_resolution=0.03, tex_res=128, amp=False)


def test_end_to_end_box_reconstruction(caplog):
    """tests/test_nerf.py's end-to-end scene, cut to finish here in
    seconds: a mesh of about the box's size with a baked texture. The
    losses are the ones train logs every tenth of the run."""
    from foundationpose_torch.nerf import run_neural_object_field

    caplog.set_level(logging.INFO, logger="foundationpose_torch.nerf.runner")
    mesh, runner = run_neural_object_field(TCfg(**E2E_CFG), *_port_box_scene(), device="cpu")
    logged = [r.args[:3] for r in caplog.records if r.msg.startswith("step ")]
    n = E2E_CFG["n_step"] + 1
    assert [it for it, _, _ in logged] == list(range(0, n, n // 10)), logged
    assert runner.global_step == n and logged[-1][2] < 0.5 * logged[0][2], logged
    assert len(mesh.vertices) > 50
    ext = mesh.bounds()[1] - mesh.bounds()[0]
    assert (ext > 0.1).all() and (ext < 0.45).all(), ext
    assert mesh.texture is not None and mesh.uv is not None and mesh.texture.shape == (128, 128, 3)


def test_model_free_run_imports_no_jax_sklearn_cv2():
    script = textwrap.dedent(
        """
        import sys
        import numpy as np
        import torch
        from foundationpose_torch.nerf import NerfCfg, run_neural_object_field

        cfg = NerfCfg(n_step=5, n_rand=64, n_samples=8, n_samples_around_depth=8, num_levels=4,
                      finest_res=64, log2_hashmap_size=12, mesh_resolution=0.03, tex_res=64, amp=False)

        def main():
            mesh, runner = run_neural_object_field(cfg, *_port_box_scene(32, 30.0), device="cpu")
            assert np.isfinite(mesh.vertices).all()
            bad = [m for m in ("jax", "foundationpose_tpu", "sklearn", "cv2", "imageio", "optax")
                   if m in sys.modules]
            assert not bad, bad
            print("OK")
        """
    ) + inspect.getsource(_port_box_scene) + "\nmain()\n"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
