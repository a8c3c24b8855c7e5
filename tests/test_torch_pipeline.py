"""The port's crops, refiner, scorer and the whole slice (register then
track) against foundationpose_tpu on the same inputs and weights.

f32 on both sides (bf16 near-ties could flip a winner); both estimators
run their unpacked full-frame path (register_pack, register_roi,
track_pack and track_roi all False; tests/test_torch_tracking.py holds
the packed and windowed paths).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from foundationpose_tpu.meshio import make_box
from foundationpose_tpu.models import networks as jnet
from foundationpose_tpu.ops import render_mesh as j_render
from foundationpose_tpu.pipeline import EstimatorCfg as JCfg
from foundationpose_tpu.pipeline import FoundationPose as JPose
from foundationpose_tpu.pipeline import RefinerCfg as JRef
from foundationpose_tpu.pipeline import ScorerCfg as JSco
from foundationpose_tpu.pipeline import make_mesh_tensors as j_mesh
from foundationpose_tpu.pipeline.crops import make_crop_inputs as j_crops
from foundationpose_tpu.pipeline.refiner import refine_poses as j_refine
from foundationpose_tpu.pipeline.scorer import score_poses as j_score
from foundationpose_torch.models import networks as tnet
from foundationpose_torch.models.convert import params_from_jax
from foundationpose_torch.pipeline import EstimatorCfg as TCfg
from foundationpose_torch.pipeline import FoundationPose as TPose
from foundationpose_torch.pipeline import RefinerCfg as TRef
from foundationpose_torch.pipeline import ScorerCfg as TSco
from foundationpose_torch.pipeline import make_mesh_tensors as t_mesh
from foundationpose_torch.pipeline.crops import make_crop_inputs as t_crops
from foundationpose_torch.pipeline.refiner import refine_poses as t_refine
from foundationpose_torch.pipeline.scorer import score_poses as t_score

KF = np.array([[140.0, 0, 80.0], [0, 140.0, 60.0], [0, 0, 1.0]], np.float32)
HW = (120, 160)
RES = 32


def _box():
    box = make_box(np.array([0.12, 0.16, 0.2]))
    box.vertex_colors = np.random.default_rng(0).integers(40, 255, size=(8, 3)).astype(np.uint8)
    return box


def _frame(box, t=(0.01, -0.02, 0.85), rot=None):
    """The box rendered by the JAX renderer at a known pose."""
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = t
    if rot is not None:
        gt[:3, :3] = rot
    fr = j_render(
        jnp.asarray(box.vertices.astype(np.float32)), jnp.asarray(box.faces.astype(np.int32)),
        jnp.asarray(gt[None]), jnp.asarray(KF), out_hw=HW,
        vertex_color=jnp.asarray(box.vertex_colors.astype(np.float32) / 255.0),
        vnormals=jnp.asarray(box.vertex_normals.astype(np.float32)), use_light=True,
        method="brute",
    )
    rgb = (np.asarray(fr.color[0]) * 255).astype(np.uint8)
    depth = np.asarray(fr.depth[0]).astype(np.float32)
    mask = np.asarray(fr.mask[0]).astype(np.uint8)
    return rgb, depth, mask


def _params(head_scale, seed=0):
    """Shared random weights; delta heads scaled to `head_scale` (0 =
    identity refinement)."""
    rc = jnet.RefineNetCfg(base_width=4)
    sc = jnet.ScoreNetCfg(base_width=4)
    rp = jax.tree.map(np.asarray, jnet.init_refine_net(jax.random.PRNGKey(seed), rc))
    sp = jax.tree.map(np.asarray, jnet.init_score_net(jax.random.PRNGKey(seed + 1), sc))
    for head in ("trans_head", "rot_head"):
        for k in ("kernel", "bias"):
            rp[head]["1"][k] = rp[head]["1"][k] * np.float32(head_scale)
    tr = tnet.RefineNet(tnet.RefineNetCfg(base_width=4))
    tr.load_state_dict(params_from_jax(rp, tr.cfg))
    ts = tnet.ScoreNetMultiPair(tnet.ScoreNetCfg(base_width=4))
    ts.load_state_dict(params_from_jax(sp, ts.cfg))
    return rp, sp, tr.eval(), ts.eval()


def _cfgs(mode="network"):
    jc = JCfg(
        refiner=JRef(net=jnet.RefineNetCfg(base_width=4), compute_dtype="float32", input_res=RES),
        scorer=JSco(net=jnet.ScoreNetCfg(base_width=4), mode=mode, input_res=RES,
                    compute_dtype="float32"),
        min_n_views=4, inplane_step_deg=120.0,
        register_pack=False, register_roi=False, track_pack=False, track_roi=False,
    )
    tc = TCfg(
        refiner=TRef(net=tnet.RefineNetCfg(base_width=4), compute_dtype="float32", input_res=RES),
        scorer=TSco(net=tnet.ScoreNetCfg(base_width=4), mode=mode, input_res=RES,
                    compute_dtype="float32"),
        min_n_views=4, inplane_step_deg=120.0,
        register_pack=False, register_roi=False, track_pack=False, track_roi=False,
    )
    return jc, tc


def _hyp_poses(n=12, seed=0):
    from foundationpose_tpu.geometry.rotations import so3_exp_map

    rng = np.random.default_rng(seed)
    P = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    P[:, :3, :3] = np.asarray(so3_exp_map(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)))
    P[:, :3, 3] = [0.012, -0.018, 0.86] + rng.normal(scale=0.01, size=(n, 3))
    return P


def _obs(box):
    from foundationpose_tpu.geometry.projection import depth_to_xyz_map

    rgb, depth, _mask = _frame(box)
    xyz = np.asarray(depth_to_xyz_map(jnp.asarray(depth), jnp.asarray(KF)))
    return rgb.astype(np.float32) / 255.0, xyz


@pytest.mark.parametrize("use_normal", [False, True])
def test_make_crop_inputs(use_normal):
    box = _box()
    rgb, xyz = _obs(box)
    P = _hyp_poses()
    kw = dict(input_res=RES, crop_ratio=1.2, normalize_xyz=True, invalid_z=0.001,
              use_normal=use_normal)
    aj, bj, tj = j_crops(j_mesh(box), jnp.asarray(P), jnp.asarray(KF), jnp.asarray(rgb),
                         jnp.asarray(xyz), 0.25, **kw)
    at, bt, tt = t_crops(t_mesh(box), torch.as_tensor(P), torch.as_tensor(KF),
                         torch.as_tensor(rgb), torch.as_tensor(xyz), 0.25, **kw)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-4, rtol=0)
    # rendered side: masks equal, values within the renderer's criterion
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=2e-4, rtol=0)


def test_refine_poses_two_iterations():
    box = _box()
    rgb, xyz = _obs(box)
    rp, _sp, tr, _ts = _params(head_scale=0.05)
    jc, tc = _cfgs()
    P = _hyp_poses()
    args_j = (j_mesh(box), jnp.asarray(P), jnp.asarray(KF), jnp.asarray(rgb), jnp.asarray(xyz), 0.25)
    args_t = (t_mesh(box), torch.as_tensor(P), torch.as_tensor(KF), torch.as_tensor(rgb),
              torch.as_tensor(xyz), 0.25)
    oj, hj = j_refine(rp, jc.refiner, *args_j, iterations=2, return_history=True)
    ot, ht = t_refine(tr, tc.refiner, *args_t, iterations=2, return_history=True)
    assert not np.allclose(np.asarray(oj), P, atol=1e-4)  # the heads moved the poses
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["network", "depth"])
def test_score_poses(mode):
    box = _box()
    rgb, xyz = _obs(box)
    _rp, sp, _tr, ts = _params(head_scale=0.0)
    jc, tc = _cfgs(mode)
    P = _hyp_poses()
    valid = np.ones(len(P), bool)
    valid[-2:] = False
    sj = j_score(sp, jc.scorer, j_mesh(box), jnp.asarray(P), jnp.asarray(KF), jnp.asarray(rgb),
                 jnp.asarray(xyz), 0.25, valid=jnp.asarray(valid))
    st = t_score(ts, tc.scorer, t_mesh(box), torch.as_tensor(P), torch.as_tensor(KF),
                 torch.as_tensor(rgb), torch.as_tensor(xyz), 0.25, valid=torch.as_tensor(valid))
    sj = np.asarray(sj)
    st = st.numpy()
    assert np.isneginf(st[-2:]).all() and np.isneginf(sj[-2:]).all()
    np.testing.assert_allclose(st[:-2], sj[:-2], rtol=1e-4, atol=1e-4)


def _registered(mode):
    box = _box()
    frame = _frame(box)
    rp, sp, tr, ts = _params(head_scale=0.05)
    jc, tc = _cfgs(mode)
    je = JPose(mesh=box, cfg=jc, refiner_params=jax.tree.map(jnp.asarray, rp),
               scorer_params=jax.tree.map(jnp.asarray, sp))
    te = TPose(mesh=box, cfg=tc, refiner_params=tr, scorer_params=ts, device="cpu")
    np.testing.assert_allclose(te.rot_grid.numpy(), np.asarray(je.rot_grid), atol=1e-6)
    pj = je.register(KF, *frame, iteration=2)
    pt = te.register(KF, *frame, iteration=2)
    # the JAX estimator keeps no order: ask its (already compiled) graph
    from foundationpose_tpu.pipeline.graph import register_graph

    order_j = np.asarray(register_graph(
        je.refiner_params, je.scorer_params, je.cfg, je.mesh_tensors, je.rot_grid,
        je.hyp_valid, jnp.asarray(KF), jnp.asarray(frame[0]), jnp.asarray(frame[1]),
        jnp.asarray(frame[2]), jnp.float32(je.diameter), iterations=2,
    )[0])
    return box, je, te, pj, pt, order_j


def test_register_then_track_matches_jax():
    """The slice end to end: register (2 refine iterations) and two
    track_one calls on the box scene, depth scorer. Seed 0 has no
    near-tie: the top-2 score gap is checked to be > 1e-4 (the gaps of
    the top 6 are > 3e-3)."""
    box, je, te, pj, pt, order_j = _registered("depth")
    sj = np.asarray(je.scores)
    assert sj[0] - sj[1] > 1e-4
    assert te.best_id == je.best_id
    np.testing.assert_array_equal(te.order[:5].numpy(), order_j[:5])
    np.testing.assert_allclose(te.scores[:5].numpy(), sj[:5], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(te.poses[:5].numpy(), np.asarray(je.poses[:5]), atol=1e-4, rtol=0)

    for t in ((0.013, -0.018, 0.86), (0.016, -0.016, 0.87)):
        frame = _frame(box, t=t)
        qj = je.track_one(frame[0], frame[1], KF, iteration=2)
        qt = te.track_one(frame[0], frame[1], KF, iteration=2)
        np.testing.assert_allclose(qt, qj, atol=1e-4, rtol=0)
        assert np.isfinite(qt).all()


def test_register_network_scorer_per_hypothesis():
    """Register with the network scorer. A random base_width=4 ScoreNet
    gives every hypothesis nearly the same logit (spread ~1e-6: its
    cross-attention averages features that barely differ), so the
    ranking is rounding noise on both sides; the refined pose and the
    score of every hypothesis are compared instead, by hypothesis id."""
    _box_, je, te, _pj, _pt, order_j = _registered("network")
    n = len(order_j)
    inv_j = np.empty(n, np.int64)
    inv_j[order_j] = np.arange(n)
    inv_t = torch.empty(n, dtype=torch.int64)
    inv_t[te.order] = torch.arange(n)
    valid = np.asarray(je.hyp_valid)
    sj = np.asarray(je.scores)[inv_j][valid]
    st = te.scores[inv_t].numpy()[valid]
    np.testing.assert_allclose(st, sj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        te.poses[inv_t].numpy(), np.asarray(je.poses)[inv_j], atol=1e-4, rtol=0
    )


@pytest.mark.parametrize("trans_rep", ["tracknet", "deepim"])
@pytest.mark.parametrize("rot_rep", ["axis_angle", "6d"])
@pytest.mark.parametrize("normalize_xyz", [True, False])
def test_apply_pose_delta(trans_rep, rot_rep, normalize_xyz):
    from foundationpose_tpu.geometry.projection import compute_crop_window_tf
    from foundationpose_tpu.pipeline.refiner import apply_pose_delta as j_apply
    from foundationpose_torch.pipeline.refiner import apply_pose_delta as t_apply

    rng = np.random.default_rng(7)
    P = _hyp_poses(8)
    trans = rng.normal(scale=0.3, size=(8, 3)).astype(np.float32)
    trans[:, 2] = 1.0 + trans[:, 2] * 0.1 if trans_rep == "deepim" else trans[:, 2]
    rot = rng.normal(scale=0.5, size=(8, 3 if rot_rep == "axis_angle" else 6)).astype(np.float32)
    tf = np.asarray(compute_crop_window_tf(jnp.asarray(P), jnp.asarray(KF), 1.2, RES, 0.25))
    jcfg = JRef(trans_rep=trans_rep, rot_rep=rot_rep, normalize_xyz=normalize_xyz, input_res=RES)
    tcfg = TRef(trans_rep=trans_rep, rot_rep=rot_rep, normalize_xyz=normalize_xyz, input_res=RES)
    oj = j_apply(jnp.asarray(P), jnp.asarray(trans), jnp.asarray(rot), jcfg, 0.25,
                 K=jnp.asarray(KF), tf_to_crops=jnp.asarray(tf))
    ot = t_apply(torch.as_tensor(P), torch.as_tensor(trans), torch.as_tensor(rot), tcfg, 0.25,
                 K=torch.as_tensor(KF), tf_to_crops=torch.as_tensor(tf))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5, rtol=0)


def test_load_weights_from_jax_npz(tmp_path):
    """Weights saved by the JAX estimator (.npz + embedded pipeline
    config) load into the port and give the same register."""
    box = _box()
    frame = _frame(box)
    rp, sp, _tr, _ts = _params(head_scale=0.05)
    jc, tc = _cfgs("network")
    je = JPose(mesh=box, cfg=jc, refiner_params=jax.tree.map(jnp.asarray, rp),
               scorer_params=jax.tree.map(jnp.asarray, sp))
    rpath, spath = str(tmp_path / "refiner.npz"), str(tmp_path / "scorer.npz")
    je.save_weights(rpath, spath)
    # defaults everywhere but the grid: the net width, crop size and
    # dtype must come from the files
    te = TPose(mesh=box, cfg=TCfg(min_n_views=4, inplane_step_deg=120.0), device="cpu")
    assert not te.has_refiner and te.cfg.scorer.mode == "depth"
    te.load_weights(rpath, spath)
    assert te.has_refiner and te.cfg.scorer.mode == "network"
    assert te.cfg.refiner.input_res == RES and te.cfg.refiner.net.base_width == 4
    assert te.cfg.scorer.compute_dtype == "float32"
    # the same upload path as te's defaults (packed, windowed register)
    ref_cfg = dataclasses.replace(tc, register_pack=True, register_roi=True)
    ref = TPose(mesh=box, cfg=ref_cfg, refiner_params=_tr, scorer_params=_ts, device="cpu")
    np.testing.assert_allclose(
        te.register(KF, *frame, iteration=1), ref.register(KF, *frame, iteration=1),
        atol=1e-6, rtol=0,
    )
