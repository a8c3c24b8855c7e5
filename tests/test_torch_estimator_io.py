"""The port's estimator completion against foundationpose_tpu on the same
numpy inputs: the funneled register and its index arithmetic, the scorer
tournament, reference configs, every checkpoint branch of
load_estimator_checkpoint, save_weights interop, ADD against a gt pose,
the metrics and the symmetry transforms.

f32 on both sides; the JAX estimator runs its unpacked full-frame path.
Tolerances are stated in each test.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.models import networks as jnet
from foundationpose_tpu.models import reference_config as jref
from foundationpose_tpu.models.loading import load_estimator_checkpoint as j_load
from foundationpose_tpu.pipeline import EstimatorCfg as JCfg
from foundationpose_tpu.pipeline import FoundationPose as JPose
from foundationpose_tpu.pipeline import make_mesh_tensors as j_mesh
from foundationpose_tpu.pipeline.graph import register_graph
from foundationpose_tpu.pipeline.scorer import score_poses_tournament as j_tournament
from foundationpose_torch.models import networks as tnet
from foundationpose_torch.models import reference_config as tref
from foundationpose_torch.models.convert import params_from_jax
from foundationpose_torch.models.loading import load_estimator_checkpoint as t_load
from foundationpose_torch.pipeline import EstimatorCfg as TCfg
from foundationpose_torch.pipeline import FoundationPose as TPose
from foundationpose_torch.pipeline import make_mesh_tensors as t_mesh
from foundationpose_torch.pipeline.graph import funnel_keep, funnel_order
from foundationpose_torch.pipeline.scorer import score_poses_tournament as t_tournament
from test_torch_pipeline import KF, RES, _box, _cfgs, _frame, _hyp_poses, _obs, _params

j_apply_refine = jax.jit(jnet.apply_refine_net, static_argnums=(1, 4))
j_apply_score = jax.jit(jnet.apply_score_net, static_argnums=(1, 4))


def _spread_scorer(sp, poses):
    """The scorer tree `sp` reshaped by chip_smoke.spread_scorer on the
    crops of `poses` (a random base_width=4 ScoreNet gives every
    hypothesis nearly the same logit; this one spreads them): (JAX tree,
    port net) with the same weights."""
    from chip_smoke import spread_scorer
    from foundationpose_torch.models.convert import params_to_jax
    from foundationpose_torch.pipeline.crops import make_crop_inputs as t_crops

    ts = tnet.ScoreNetMultiPair(tnet.ScoreNetCfg(base_width=4))
    ts.load_state_dict(params_from_jax(sp, ts.cfg))
    box = _box()
    rgb, xyz = _obs(box)
    a, b, _ = t_crops(t_mesh(box), torch.as_tensor(poses, dtype=torch.float32), torch.as_tensor(KF),
                      torch.as_tensor(rgb), torch.as_tensor(xyz), 0.25, input_res=RES,
                      crop_ratio=1.2, normalize_xyz=True, invalid_z=0.1)
    spread_scorer(ts.eval(), a, b)
    return params_to_jax(ts.state_dict()), ts


def _estimators(mode, spread_on=None, **cfg_kw):
    box = _box()
    rp, sp, tr, ts = _params(head_scale=0.05)
    if spread_on is not None:
        sp, ts = _spread_scorer(sp, spread_on)
    jc, tc = _cfgs(mode)
    jc, tc = dataclasses.replace(jc, **cfg_kw), dataclasses.replace(tc, **cfg_kw)
    je = JPose(mesh=box, cfg=jc, refiner_params=jax.tree.map(jnp.asarray, rp),
               scorer_params=jax.tree.map(jnp.asarray, sp))
    te = TPose(mesh=box, cfg=tc, refiner_params=tr, scorer_params=ts, device="cpu")
    return box, je, te


# ------------------------------------------------------------- the funnel


@pytest.mark.parametrize("mode", ["depth", "network"])
def test_funneled_register_matches_jax(mode):
    """prune after 1 of 2 iterations, keep 8: the whole order equal,
    poses within 1e-4, survivors' scores offset by 1e5 as in
    tests/test_pipeline.py::test_register_funneling_matches_full, scores
    within 1e-4 (relative 1e-4 on the offset ones)."""
    funnel = dict(prune_after_iter=1, prune_keep=8)
    box, je, te = _estimators(mode, **funnel)
    frame = _frame(box)
    if mode == "network":
        # The survivors and their poses do not depend on the scorer: a
        # first run finds them, the scorer is spread on them.
        te.register(KF, *frame, iteration=2)
        box, je, te = _estimators(mode, spread_on=te.poses[:8].numpy(), **funnel)
    n = len(te.hyp_valid)
    assert n > 8 and not bool(te.hyp_valid.all())  # a pruned set and padded rows
    pj = je.register(KF, *frame, iteration=2)
    pt = te.register(KF, *frame, iteration=2)
    order_j = np.asarray(register_graph(
        je.refiner_params, je.scorer_params, je.cfg, je.mesh_tensors, je.rot_grid,
        je.hyp_valid, jnp.asarray(KF), jnp.asarray(frame[0]), jnp.asarray(frame[1]),
        jnp.asarray(frame[2]), jnp.float32(je.diameter), iterations=2,
    )[0])
    np.testing.assert_array_equal(te.order.numpy(), order_j)
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(te.poses.numpy(), np.asarray(je.poses), atol=1e-4, rtol=0)
    sj, st = np.asarray(je.scores), te.scores.numpy()
    np.testing.assert_array_equal(np.isfinite(st), np.isfinite(sj))
    fin = np.isfinite(sj)
    np.testing.assert_allclose(st[fin], sj[fin], rtol=1e-4, atol=1e-4)
    n_surv = int((st[np.isfinite(st)] > 1e4).sum())
    assert n_surv == 8 and (st[:n_surv] > 1e4).all()
    if mode == "network":  # the survivors' network scores are not near-ties
        assert np.diff(np.sort(st[:8] - 1e5)).min() > 1e-3


def _jax_funnel(pre, sub_fn, keep, hyp_valid):
    """The index arithmetic of foundationpose_tpu/pipeline/graph.py
    `_register_body`, as written there (top_k + the two argsorts)."""
    pre = jnp.asarray(pre)
    hyp_valid = jnp.asarray(hyp_valid)
    _, keep_idx = jax.lax.top_k(pre, keep)
    sub_scores = jnp.asarray(sub_fn(np.asarray(keep_idx)))
    scores = pre.at[keep_idx].set(sub_scores + 1e5)
    surv_order_local = jnp.argsort(-jnp.where(hyp_valid[keep_idx], sub_scores, -jnp.inf))
    surv_ids = keep_idx[surv_order_local]
    rest_key = jnp.where(hyp_valid, pre, jnp.float32(-3e38))
    rest_key = rest_key.at[keep_idx].set(-jnp.inf)
    rest_ids = jnp.argsort(-rest_key)[: pre.shape[0] - keep]
    return np.asarray(keep_idx), np.asarray(jnp.concatenate([surv_ids, rest_ids])), np.asarray(scores)


@pytest.mark.parametrize("seed,n,keep,n_invalid", [
    (0, 20, 8, 4), (1, 12, 10, 4), (2, 16, 4, 0), (3, 32, 31, 3), (4, 9, 8, 8),
])
def test_funnel_index_arithmetic_matches_jax(seed, n, keep, n_invalid):
    """Seeded scores drawn from a few values (ties everywhere), -inf on
    the invalid padded rows (as score_poses masks them), survivors whose
    final score is -inf when more are kept than are valid. Exact."""
    rng = np.random.default_rng(seed)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n_invalid, replace=False)] = False
    pre = (rng.integers(0, 4, n) / 4.0).astype(np.float32)
    pre[~valid] = -np.inf
    sub_all = (rng.integers(0, 3, n) / 2.0 - 3.0).astype(np.float32)

    def sub_fn(idx):
        return np.where(valid[idx], sub_all[idx], -np.inf).astype(np.float32)

    keep_j, order_j, scores_j = _jax_funnel(pre, sub_fn, keep, valid)
    pre_t, valid_t = torch.as_tensor(pre), torch.as_tensor(valid)
    keep_t = funnel_keep(pre_t, keep)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    order_t, scores_t = funnel_order(pre_t, torch.as_tensor(sub_fn(keep_t.numpy())), keep_t, valid_t)
    np.testing.assert_array_equal(order_t.numpy(), order_j)
    np.testing.assert_array_equal(scores_t.numpy(), scores_j)
    assert sorted(order_t.tolist()) == list(range(n))


# --------------------------------------------------------- the tournament


@pytest.mark.parametrize("mode,n,group", [
    ("depth", 12, 64), ("depth", 10, 4), ("network", 10, 4), ("network", 12, 5),
])
def test_tournament_matches_jax(mode, n, group):
    """tests/test_aux.py::TestTournament's cases (one group; N = 10 in
    chunks of 4 with the exact pose hidden in chunk 2) on both sides:
    the same rows win, scores within 1e-4, eliminated rows at 0."""
    box = _box()
    rgb, xyz = _obs(box)
    _rp, sp, _tr, ts = _params(head_scale=0.0)
    jc, tc = _cfgs(mode)
    P = _hyp_poses(n, seed=1)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.01, -0.02, 0.85]
    P[7] = gt
    if mode == "network":
        sp, ts = _spread_scorer(sp, P)
    valid = np.ones(n, bool)
    valid[3] = False
    sj = np.asarray(j_tournament(
        jax.tree.map(jnp.asarray, sp), jc.scorer, j_mesh(box), jnp.asarray(P), jnp.asarray(KF),
        jnp.asarray(rgb), jnp.asarray(xyz), jnp.float32(0.25), valid=jnp.asarray(valid),
        group_size=group))
    st = t_tournament(ts, tc.scorer, t_mesh(box), torch.as_tensor(P), torch.as_tensor(KF),
                      torch.as_tensor(rgb), torch.as_tensor(xyz), 0.25,
                      valid=torch.as_tensor(valid), group_size=group).numpy()
    np.testing.assert_array_equal(np.isfinite(st), np.isfinite(sj))
    fin = np.isfinite(sj)
    np.testing.assert_allclose(st[fin], sj[fin], rtol=1e-4, atol=1e-4)
    assert np.argmax(st) == np.argmax(sj)
    if n > group:
        assert (st == 0).any() and (st > 50).sum() >= 1
        np.testing.assert_array_equal(st == 0, sj == 0)
    if mode == "depth":
        assert np.argmax(st) == 7


def test_tournament_pads_cyclically_where_jax_fails():
    """9 hypotheses in groups of 8 leave 2 finalists padded by 6 rows:
    the JAX package pads with cur[:pad] (2 rows) and fails; the port
    repeats the finalists cyclically. Depth scorer: the finalists carry
    their own score + 100 (within 1e-5), the global best wins."""
    from foundationpose_torch.pipeline.scorer import score_poses as t_score

    box = _box()
    rgb, xyz = _obs(box)
    jc, tc = _cfgs("depth")
    P = _hyp_poses(9, seed=1)
    P[8, :3, :3] = np.eye(3)
    P[8, :3, 3] = [0.01, -0.02, 0.85]
    args = (t_mesh(box), torch.as_tensor(P), torch.as_tensor(KF), torch.as_tensor(rgb),
            torch.as_tensor(xyz), 0.25)
    with pytest.raises(ValueError):
        j_tournament(None, jc.scorer, j_mesh(box), jnp.asarray(P), jnp.asarray(KF),
                     jnp.asarray(rgb), jnp.asarray(xyz), jnp.float32(0.25), group_size=8)
    st = t_tournament(None, tc.scorer, *args, group_size=8).numpy()
    single = t_score(None, tc.scorer, *args).numpy()
    finalists = np.flatnonzero(st)
    assert len(finalists) == 2 and np.argmax(st) == np.argmax(single) == 8
    np.testing.assert_allclose(st[finalists], single[finalists] + 100.0, atol=1e-5, rtol=0)


# ----------------------------------------------------- reference configs


def _cfg_fields(cfg) -> dict:
    """A RefinerCfg / ScorerCfg of either package as a dict: every field
    but the raster's, of which the port keeps only cull_backfaces."""
    d = dataclasses.asdict(cfg)
    d["raster"] = {"cull_backfaces": d["raster"]["cull_backfaces"]}
    return d


REF_CASES = [
    ("defaults", "refiner", {}),
    ("defaults", "scorer", {}),
    ("defaults", "refiner", {"crop_ratio": None}),
    ("defaults", "refiner", {"zfar": "Infinity"}),
    ("defaults", "refiner", {"zfar": ".inf"}),
    ("defaults", "refiner", {"zfar": "INF"}),
    ("defaults", "refiner", {"rot_rep": "6d", "c_in": 6}),
    ("zfar", "refiner", {"zfar": 2.5}),
    ("zfar", "scorer", {}),
    ("cfg", "refiner", {
        "c_in": 6, "use_BN": True, "rot_rep": "6d", "trans_rep": "deepim",
        "normalize_xyz": True, "crop_ratio": 1.5, "trans_normalizer": [0.01, 0.02, 0.03],
        "rot_normalizer": 0.5, "zfar": "Infinity", "input_resize": [160, 160]}),
    ("cfg", "refiner", {"c_in": 6, "trans_normalizer": 0.03}),
    ("cfg", "scorer", {"c_in": 6, "use_BN": False}),
    ("cfg", "refiner", {}),  # c_in 4 by default: rejected
    ("cfg", "scorer", {"c_in": 9}),
    ("cfg", "refiner", {"c_in": 9, "use_normal": True}),
    ("cfg", "refiner", {"c_in": 6, "use_normal": True}),
    ("cfg", "refiner", {"c_in": 6, "use_mask": True}),
    ("cfg", "refiner", {"c_in": 6, "n_view": 2}),
    ("cfg", "refiner", {"c_in": 6, "input_resize": [160, 128]}),
]


@pytest.mark.parametrize("what,kind,raw", REF_CASES)
def test_reference_config_matches_jax(what, kind, raw):
    """The cases of tests/test_reference_config.py on both packages:
    defaulted dicts, typed configs field by field and zfar equal, and the
    same ValueError where the JAX package rejects a config."""
    if what == "defaults":
        assert tref.apply_reference_defaults(raw, kind) == jref.apply_reference_defaults(raw, kind)
        return
    if what == "zfar":
        assert tref.zfar_from_reference(raw, kind) == jref.zfar_from_reference(raw, kind)
        return
    fn = "refiner_cfg_from_reference" if kind == "refiner" else "scorer_cfg_from_reference"
    try:
        want = _cfg_fields(getattr(jref, fn)(raw))
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            getattr(tref, fn)(raw)
        return
    assert _cfg_fields(getattr(tref, fn)(raw)) == want


# ---------------------------------------------------------- checkpoints


def _inputs(res, n=2, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, res, res, 6)).astype(np.float32),
            rng.standard_normal((n, res, res, 6)).astype(np.float32))


def _outputs(kind, jparams, jcfg, tsd, tcfg, res):
    """(JAX outputs, port outputs) of one checkpoint, f32, at `res`."""
    A, B = _inputs(res)
    if kind == "refiner":
        jo = j_apply_refine(jparams, jcfg.net, jnp.asarray(A), jnp.asarray(B), jnp.float32)
        jo = np.concatenate([np.asarray(jo["trans"]), np.asarray(jo["rot"])], axis=1)
        net = tnet.RefineNet(tcfg.net)
    else:
        jo = np.asarray(j_apply_score(jparams, jcfg.net, jnp.asarray(A), jnp.asarray(B), jnp.float32))
        net = tnet.ScoreNetMultiPair(tcfg.net)
    net.load_state_dict(tsd, strict=True)
    with torch.no_grad():
        to = net.eval()(torch.as_tensor(A), torch.as_tensor(B), dtype=torch.float32)
    to = torch.cat([to["trans"], to["rot"]], dim=1) if kind == "refiner" else to
    return jo, to.numpy()


def _check_same(path, kind, res=32):
    """Both loaders on one file: cfg equal field by field, zfar equal,
    outputs within 1e-5 (f32). Returns the port's (state_dict, cfg)."""
    jparams, jcfg, jz = j_load(path, kind)
    tsd, tcfg, tz = t_load(path, kind)
    assert _cfg_fields(tcfg) == _cfg_fields(jcfg)
    assert tz == jz
    jo, to = _outputs(kind, jparams, jcfg, tsd, tcfg, res)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
    return tsd, tcfg


def _write_pth(run_dir, kind, use_bn, rot_dim, cfg_yaml, extra_pe=False):
    """model_best.pth (+ config.yml) the way reference runs ship them:
    {'model': ...}, DataParallel 'module.' prefixes."""
    import yaml

    from test_networks import TorchRefineNet, TorchScoreNet, randomize_bn_stats

    torch.manual_seed(3)
    net = (TorchRefineNet(c_in=6, use_bn=use_bn, rot_dim=rot_dim) if kind == "refiner"
           else TorchScoreNet(c_in=6, use_bn=use_bn)).eval()
    if use_bn:
        randomize_bn_stats(net, seed=3)
    sd = {f"module.{k}": v for k, v in net.state_dict().items()}
    if extra_pe:  # the reference's registered positional table
        sd["module.pos_embed.pe"] = torch.zeros(1, 512, 512)
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "model_best.pth")
    torch.save({"model": sd, "epoch": 7}, path)
    if cfg_yaml is not None:
        with open(os.path.join(run_dir, "config.yml"), "w") as f:
            yaml.safe_dump(cfg_yaml, f)
    return path, net


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
@pytest.mark.parametrize("use_bn", [True, False])
@pytest.mark.parametrize("sidecar", [True, False])
def test_pth_checkpoint_matches_jax(tmp_path, kind, use_bn, sidecar):
    """A reference .pth, with and without its sidecar config.yml (a
    non-default one: 6d rotation, crop ratio 1.4, normalizers, zfar),
    through both loaders; with the sidecar, also the JAX package's
    cli.convert_weights .npz of it (reference_config embedded)."""
    from foundationpose_tpu.cli.convert_weights import main as convert_main

    cfg_yaml = None
    if sidecar:
        cfg_yaml = {"c_in": 6, "use_BN": use_bn, "normalize_xyz": True, "crop_ratio": 1.4,
                    "input_resize": [160, 160]}
        if kind == "refiner":
            cfg_yaml.update(rot_rep="6d", trans_normalizer=[0.019999, 0.019999, 0.05],
                            rot_normalizer=0.3490658503988659, zfar="Infinity")
    rot_dim = 6 if sidecar else 3
    path, src = _write_pth(str(tmp_path / "run"), kind, use_bn, rot_dim, cfg_yaml,
                           extra_pe=use_bn)
    tsd, tcfg = _check_same(path, kind)
    assert tcfg.net.use_bn is use_bn
    assert all(torch.equal(tsd[k], v) for k, v in src.state_dict().items())
    if kind == "scorer":
        assert tcfg.mode == "network"
    if sidecar:
        assert tcfg.crop_ratio == 1.4
        flag = "--refiner_ckpt" if kind == "refiner" else "--scorer_ckpt"
        convert_main([flag, path, "--out_dir", str(tmp_path / "npz")])
        _, ncfg = _check_same(str(tmp_path / "npz" / f"{kind}.npz"), kind)
        assert ncfg == tcfg


def _jax_estimator(scorer_mode="network"):
    box = _box()
    rp, sp, tr, ts = _params(head_scale=0.05)
    jc, tc = _cfgs(scorer_mode)
    je = JPose(mesh=box, cfg=jc, refiner_params=jax.tree.map(jnp.asarray, rp),
               scorer_params=jax.tree.map(jnp.asarray, sp))
    return box, je, (rp, sp, tr, ts), tc


@pytest.mark.parametrize("scorer_mode", ["network", "depth"])
def test_save_weights_npz_matches_jax(tmp_path, scorer_mode):
    """A JAX FoundationPose.save_weights .npz (pipeline config embedded):
    both loaders agree, and a scorer saved in depth mode loads in depth
    mode into the port's estimator, as into the JAX package's."""
    box, je, _p, _tc = _jax_estimator(scorer_mode)
    assert je.cfg.scorer.mode == scorer_mode
    rpath, spath = str(tmp_path / "refiner.npz"), str(tmp_path / "scorer.npz")
    je.save_weights(rpath, spath)
    _check_same(rpath, "refiner", RES)
    _, scfg = _check_same(spath, "scorer", RES)
    assert scfg.mode == scorer_mode
    te = TPose(mesh=box, cfg=dataclasses.replace(_tc, zfar=1.5), device="cpu")
    te.load_weights(rpath, spath)
    je2 = JPose(mesh=box, cfg=dataclasses.replace(je.cfg, zfar=1.5))
    je2.load_weights(rpath, spath)
    assert te.cfg.scorer.mode == je2.cfg.scorer.mode == scorer_mode
    assert te.cfg.zfar == je2.cfg.zfar == 1.5  # no reference config: zfar kept


def test_bare_npz_matches_jax(tmp_path):
    """A .npz with no meta: the defaults with use_bn read from the
    weights (and network mode for a scorer), in both packages."""
    from foundationpose_tpu.utils.checkpoint import save_params

    rp, sp, _tr, _ts = _params(head_scale=0.05)
    base = _cfgs()
    for kind, tree in (("refiner", rp), ("scorer", sp)):
        path = str(tmp_path / f"{kind}.npz")
        save_params(path, tree)
        jparams, jcfg, jz = j_load(path, kind, base=getattr(base[0], kind))
        tsd, tcfg, tz = t_load(path, kind, base=getattr(base[1], kind))
        assert _cfg_fields(tcfg) == _cfg_fields(jcfg) and tz is jz is None
        assert tcfg.net.use_bn is True and (kind == "refiner" or tcfg.mode == "network")
        jo, to = _outputs(kind, jparams, jcfg, tsd, tcfg, RES)
        np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)


def test_pth_zfar_reaches_estimator(tmp_path):
    """A refiner .pth with a sidecar that sets no zfar: the reference's
    refiner default of 3 m becomes EstimatorCfg.zfar in both packages."""
    path, _ = _write_pth(str(tmp_path / "run"), "refiner", False, 6,
                         {"c_in": 6, "use_BN": False, "rot_rep": "6d"})
    box = _box()
    grid = dict(min_n_views=4, inplane_step_deg=120.0)  # full-width nets, a small grid
    te = TPose(mesh=box, cfg=TCfg(**grid), device="cpu")
    te.load_weights(refiner_path=path)
    je = JPose(mesh=box, cfg=JCfg(**grid))
    je.load_weights(refiner_path=path)
    assert te.cfg.zfar == je.cfg.zfar == 3.0
    assert te.has_refiner and te.cfg.refiner.rot_rep == "6d"


def test_port_save_weights_loads_in_jax(tmp_path):
    """The port's save_weights writes what the JAX package loads: same
    configs, outputs within 1e-5; and the port reloads it bit-equal."""
    box, _je, (_rp, _sp, tr, ts), tc = _jax_estimator()
    te = TPose(mesh=box, cfg=tc, refiner_params=tr, scorer_params=ts, device="cpu")
    rpath, spath = str(tmp_path / "r.npz"), str(tmp_path / "s.npz")
    te.save_weights(rpath, spath)
    for path, kind in ((rpath, "refiner"), (spath, "scorer")):
        tsd, tcfg = _check_same(path, kind, RES)
        assert tcfg == getattr(tc, kind)
        src = getattr(te, kind).state_dict()
        assert all(torch.equal(tsd[k], v) for k, v in src.items())
    je = JPose(mesh=box, cfg=_cfgs()[0])
    je.load_weights(rpath, spath)
    assert _cfg_fields(je.cfg.scorer) == _cfg_fields(tc.scorer)


def test_compute_add_err_to_gt_pose_matches_jax():
    box, je, te = _estimators("depth")
    rng = np.random.default_rng(3)
    poses = _hyp_poses(5, seed=2).astype(np.float64)
    np.testing.assert_array_equal(te.compute_add_err_to_gt_pose(poses), -np.ones(5))
    gt = poses[2].copy()
    gt[:3, 3] += rng.normal(0, 0.01, 3)
    je.gt_pose = te.gt_pose = gt
    a = te.compute_add_err_to_gt_pose(poses)
    np.testing.assert_allclose(a, je.compute_add_err_to_gt_pose(poses), rtol=1e-12, atol=0)
    assert (a > 0).all()


# ------------------------------------------------- metrics and symmetry


def test_metrics_match_jax():
    from foundationpose_tpu.utils import metrics as jm
    from foundationpose_torch.utils import metrics as tm

    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.1, 0.1, (500, 3))
    for _ in range(4):
        pred, gt = _hyp_poses(2, seed=int(rng.integers(1000))).astype(np.float64)
        for fn in ("add_err", "adds_err", "rotation_geodesic_deg"):
            args = (pred, gt, pts) if fn != "rotation_geodesic_deg" else (pred, gt)
            np.testing.assert_allclose(getattr(tm, fn)(*args), getattr(jm, fn)(*args),
                                       rtol=1e-12, atol=1e-12)
    errs = rng.uniform(0, 0.15, 40)
    for kw in ({}, {"max_val": 0.05, "step": 0.002}):
        np.testing.assert_allclose(tm.compute_auc(errs, **kw), jm.compute_auc(errs, **kw),
                                   rtol=1e-12, atol=1e-12)
    assert tm.compute_auc(np.zeros(3)) > 0.99


@pytest.mark.parametrize("info", [
    {},
    {"symmetries_discrete": [np.diag([-1.0, -1.0, 1.0, 1.0]).reshape(16).tolist(),
                             [1, 0, 0, 5.0, 0, -1, 0, 0, 0, 0, -1, 2.0, 0, 0, 0, 1]]},
    {"symmetries_continuous": [{"axis": [1, 0, 0], "offset": [0, 0, 0]}]},
    {"symmetries_continuous": [{"axis": [0, 1, 0], "offset": [0.0, 0.01, 0]}]},
    {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}],
     "symmetries_discrete": [np.diag([1.0, -1.0, -1.0, 1.0]).reshape(16).tolist()]},
])
def test_symmetry_tfs_match_jax(info):
    from foundationpose_tpu.geometry.symmetry import symmetry_tfs_from_info as j_sym
    from foundationpose_torch.geometry.symmetry import symmetry_tfs_from_info as t_sym

    for step in (5, 30):
        np.testing.assert_array_equal(t_sym(info, rot_angle_discrete=step),
                                      j_sym(info, rot_angle_discrete=step))
