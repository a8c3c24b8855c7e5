"""The port's sharding (foundationpose_torch/parallel) against
foundationpose_tpu.parallel on the same numpy inputs: the helpers, the
hypothesis-sharded scoring, refinement and register (full and funneled,
packed and unpacked uploads) over 8 CPU shards, MultiTracker on a sharded
estimator, and the data-parallel train steps.

A mesh of 8 CPU shards stands in for the JAX package's 8 virtual host
devices (tests/conftest.py). f32 on both sides. Tolerances, stated where
used: poses 1e-4 and the same order (the JAX sharded tests' 1e-4);
scores 1e-4; train steps by tests/test_torch_training.py's bounds (losses
relative chip_smoke.TRAIN_LOSS_RTOL, parameters by
chip_smoke.param_agreement). The comparisons with the JAX package's
sharded register are `slow`, as tests/test_sharding.py's are; the port's
sharded paths are also held against its own unsharded ones in tier 1.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_LOSS_RTOL, agreement_ok, param_agreement
from foundationpose_tpu import parallel as jpar
from foundationpose_tpu.models import training as jtr
from foundationpose_tpu.pipeline import FoundationPose as JPose
from foundationpose_tpu.pipeline import MultiTracker as JMulti
from foundationpose_torch import parallel as tpar
from foundationpose_torch.models import training as ttr
from foundationpose_torch.models.convert import params_from_jax
from foundationpose_torch.pipeline import FoundationPose as TPose
from foundationpose_torch.pipeline import MultiTracker as TMulti
from foundationpose_torch.pipeline import make_mesh_tensors as t_mesh
from foundationpose_torch.pipeline.refiner import refine_poses as t_refine
from foundationpose_torch.pipeline.scorer import score_poses, score_poses_sharded
from test_torch_estimator_io import _spread_scorer
from test_torch_pipeline import KF, _box, _cfgs, _frame, _hyp_poses, _obs, _params

CPU8 = tpar.make_device_mesh(8, device="cpu")


# ------------------------------------------------------------- helpers


@pytest.mark.parametrize("n,multiple,fill", [(13, 8, 0), (16, 8, 0), (5, 3, -1.5), (1, 4, 7)])
def test_pad_to_multiple_bit_equal_to_jax(n, multiple, fill):
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    pj, mj = jpar.pad_to_multiple(jnp.asarray(x), multiple, fill=fill)
    pt, mt = tpar.pad_to_multiple(torch.as_tensor(x), multiple, fill=fill)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    xt = torch.as_tensor(x.T.copy())
    pt1, mt1 = tpar.pad_to_multiple(xt, multiple, axis=1, fill=fill)
    pj1, _ = jpar.pad_to_multiple(jnp.asarray(x.T), multiple, axis=1, fill=fill)
    np.testing.assert_array_equal(pt1.numpy(), np.asarray(pj1))


@pytest.mark.parametrize("n", [12, 16, 3])
def test_shard_hypotheses_bit_equal_to_jax(n):
    """Identity padding to a multiple of 8, one block a device, the valid
    mask alongside."""
    poses = _hyp_poses(n, seed=n)
    pj, vj = jpar.shard_hypotheses(jnp.asarray(poses), jpar.make_device_mesh())
    pt, vt = tpar.shard_hypotheses(torch.as_tensor(poses), CPU8)
    assert len(pt) == len(vt) == 8 and len({p.shape[0] for p in pt}) == 1
    np.testing.assert_array_equal(torch.cat(pt).numpy(), np.asarray(pj))
    np.testing.assert_array_equal(torch.cat(vt).numpy(), np.asarray(vj))
    shard_rows = [s.data.shape[0] for s in pj.addressable_shards]
    assert shard_rows == [p.shape[0] for p in pt]


def test_device_mesh_and_replicas():
    assert CPU8.size == 8 and CPU8.first == torch.device("cpu") and CPU8.axis == tpar.HYP_AXIS
    m = tpar.make_device_mesh(axis=tpar.DATA_AXIS, devices=["cpu", "cpu"])
    assert m.devices == (torch.device("cpu"),) * 2 and m.axis == "data"
    with pytest.raises(ValueError):
        tpar.make_device_mesh(3, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpar.make_device_mesh(2)
    net = torch.nn.Linear(2, 2)
    reps = tpar.replicate_tree({"net": net, "t": torch.ones(2), "k": None}, m)
    assert reps[0] is reps[1] and reps[0]["net"] is net  # a device that repeats: the same object
    # "cpu" and "cpu:1" are two mesh devices: the second gets a copy, as a
    # second card would, holding the module's current values
    two = tpar.make_device_mesh(devices=["cpu", "cpu:1"])
    with torch.no_grad():
        net.weight.fill_(3.0)
    a, b = tpar.replicate_tree(net, two)
    assert a is net and b is not net and torch.equal(b.weight, net.weight)
    with pytest.raises(ValueError, match="not both"):
        TPose(mesh=_box(), cfg=_cfgs("depth")[1], device="cpu", n_devices=2, device_mesh=two)
    x = torch.arange(16.0).reshape(8, 2)
    parts = tpar.batch_sharding(m)(x)
    assert [p.shape for p in parts] == [(4, 2), (4, 2)] and torch.equal(torch.cat(parts), x)
    assert all(torch.equal(r, x) for r in tpar.replicated(m)(x))
    with pytest.raises(ValueError):
        tpar.batch_sharding(CPU8)(x[:5])
    with pytest.raises(ValueError):
        tpar.batch_sharding(m, axis="hyp")


# ------------------------------------------------- sharded score / refine


def _scene(mode):
    box = _box()
    rgb, xyz = _obs(box)
    poses = _hyp_poses(16)
    rp, sp, tr, ts = _params(head_scale=0.05)
    if mode == "network":
        sp, ts = _spread_scorer(sp, poses)
    _jc, tc = _cfgs(mode)
    return box, rgb, xyz, poses, rp, sp, tr, ts, tc


def _port_sharded_scores(ts, cfg, mt, poses, rgb, xyz):
    parts, valid = tpar.shard_hypotheses(torch.as_tensor(poses), CPU8)
    reps = tpar.replicate_tree((ts, mt, torch.as_tensor(KF), torch.as_tensor(rgb),
                                torch.as_tensor(xyz), 0.25), CPU8)
    return score_poses_sharded(reps, cfg.scorer, parts, torch.cat(valid)).numpy()


@pytest.mark.parametrize("mode", ["depth", "network"])
def test_sharded_scoring_matches_unsharded(mode):
    """16 hypotheses over 8 shards: each shard's crops and trunk, the
    pooled features gathered for the cross attention; scores within 1e-4
    of the unsharded pass (network scorer spread: no ties)."""
    box, rgb, xyz, poses, _rp, _sp, _tr, ts, tc = _scene(mode)
    mt = t_mesh(box)
    want = score_poses(ts, tc.scorer, mt, torch.as_tensor(poses), torch.as_tensor(KF),
                       torch.as_tensor(rgb), torch.as_tensor(xyz), 0.25).numpy()
    got = _port_sharded_scores(ts, tc, mt, poses, rgb, xyz)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if mode == "network":
        assert np.ptp(want) > 1e-2


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["depth", "network"])
def test_sharded_scoring_matches_jax(mode):
    """The same against the JAX package's score_poses on its 8-device mesh."""
    from foundationpose_tpu.pipeline import make_mesh_tensors as j_mesh
    from foundationpose_tpu.pipeline.scorer import score_poses as j_score

    jc, _tc = _cfgs(mode)
    box, rgb, xyz, poses, _rp, sp, _tr, ts, tc = _scene(mode)
    mj = jpar.make_device_mesh()
    ph, vh = jpar.shard_hypotheses(jnp.asarray(poses), mj)
    want = np.asarray(j_score(jax.tree.map(jnp.asarray, sp), jc.scorer, jpar.replicate_tree(j_mesh(box), mj),
                              ph, jnp.asarray(KF), jnp.asarray(rgb), jnp.asarray(xyz), jnp.float32(0.25),
                              valid=vh))
    got = _port_sharded_scores(ts, tc, t_mesh(box), poses, rgb, xyz)
    np.testing.assert_allclose(got[:16], want[:16], atol=1e-4, rtol=0)


def _port_sharded_refine(tr, tc, mt, poses, rgb, xyz):
    parts, _valid = tpar.shard_hypotheses(torch.as_tensor(poses), CPU8)
    nets = tpar.replicate_tree((tr, mt), CPU8)
    return torch.cat([t_refine(net, tc.refiner, m, p, torch.as_tensor(KF), torch.as_tensor(rgb),
                               torch.as_tensor(xyz), 0.25, iterations=1)
                      for (net, m), p in zip(nets, parts)]).numpy()


def test_sharded_refine_matches_unsharded():
    box, rgb, xyz, poses, _rp, _sp, tr, _ts, tc = _scene("depth")
    mt = t_mesh(box)
    want = t_refine(tr, tc.refiner, mt, torch.as_tensor(poses), torch.as_tensor(KF),
                    torch.as_tensor(rgb), torch.as_tensor(xyz), 0.25, iterations=1).numpy()
    got = _port_sharded_refine(tr, tc, mt, poses, rgb, xyz)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(want - poses).max() > 1e-4  # the heads are live


@pytest.mark.slow
def test_sharded_refine_matches_jax():
    from foundationpose_tpu.pipeline import make_mesh_tensors as j_mesh
    from foundationpose_tpu.pipeline.refiner import refine_poses as j_refine

    jc, _tc = _cfgs("depth")
    box, rgb, xyz, poses, rp, _sp, tr, _ts, tc = _scene("depth")
    mj = jpar.make_device_mesh()
    ph, _vh = jpar.shard_hypotheses(jnp.asarray(poses), mj)
    want = np.asarray(j_refine(jpar.replicate_tree(jax.tree.map(jnp.asarray, rp), mj), jc.refiner,
                               jpar.replicate_tree(j_mesh(box), mj), ph, jnp.asarray(KF),
                               jnp.asarray(rgb), jnp.asarray(xyz), jnp.float32(0.25), iterations=1))
    got = _port_sharded_refine(tr, tc, t_mesh(box), poses, rgb, xyz)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ----------------------------------------------------- sharded register

UPLOADS = {"unpacked": {}, "packed": dict(register_pack=True, register_roi=True)}
FUNNEL = dict(prune_after_iter=1, prune_keep=8)


def _estimators(mode, upload, funnel, n_devices):
    """(box, port unsharded, port sharded): the same weights; the network
    scorer spread on the funnel's survivors (or the top 16), so that the
    ranking is not rounding noise."""
    box = _box()
    _rp, sp, tr, ts = _params(head_scale=0.05)
    _jc, tc = _cfgs(mode)
    tc = dataclasses.replace(tc, **UPLOADS[upload], **(FUNNEL if funnel else {}))
    frame = _frame(box)
    if mode == "network":
        probe = TPose(mesh=box, cfg=tc, refiner_params=tr, scorer_params=ts, device="cpu")
        probe.register(KF, *frame, iteration=2)
        sp, ts = _spread_scorer(sp, probe.poses[:8 if funnel else 16].numpy())
    t1 = TPose(mesh=box, cfg=tc, refiner_params=tr, scorer_params=ts, device="cpu")
    tn = TPose(mesh=box, cfg=tc, refiner_params=tr, scorer_params=ts, device="cpu", n_devices=n_devices)
    return box, frame, sp, t1, tn


def _check_same_register(a, b, pa, pb, n):
    """b's register against a's: the same order over a's n hypotheses,
    poses and scores within 1e-4 (b's rows past n are its extra padding)."""
    np.testing.assert_array_equal(b.order[:n].numpy(), a.order[:n].numpy())
    np.testing.assert_allclose(pb, pa, atol=1e-4, rtol=0)
    np.testing.assert_allclose(b.poses[:n].numpy(), a.poses[:n].numpy(), atol=1e-4, rtol=0)
    sa, sb = a.scores[:n].numpy(), b.scores[:n].numpy()
    fin = np.isfinite(sa)
    np.testing.assert_array_equal(np.isfinite(sb), fin)
    np.testing.assert_allclose(sb[fin], sa[fin], atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("upload", list(UPLOADS))
@pytest.mark.parametrize("mode,funnel", [("depth", False), ("network", False), ("depth", True),
                                         ("network", True)])
def test_sharded_register_matches_unsharded(mode, funnel, upload):
    """FoundationPose(n_devices=8) on the CPU against the unsharded port:
    the rotation grid padded to lcm(rot_grid_pad, 8), the same order,
    poses and scores; the funneled register's survivors re-split over
    the shards after the first-device ranking."""
    box, frame, _sp, t1, t8 = _estimators(mode, upload, funnel, 8)
    assert t8.device_mesh.size == 8 and t8.rot_grid.shape[0] % 8 == 0
    p1 = t1.register(KF, *frame, iteration=2)
    p8 = t8.register(KF, *frame, iteration=2)
    n = int(t1.hyp_valid.sum())
    assert n > 8 and not bool(t8.hyp_valid.all())
    _check_same_register(t1, t8, p1, p8, n)
    if funnel:
        assert int((t8.scores > 1e4).sum()) == 8


@pytest.mark.slow
@pytest.mark.parametrize("mode,funnel", [("depth", False), ("network", False), ("depth", True),
                                         ("network", True)])
def test_sharded_register_matches_jax(mode, funnel):
    """The port's 8-shard register against the JAX package's
    FoundationPose(n_devices=8) (unpacked uploads, as the JAX tests):
    poses in the same order within 1e-4."""
    box, frame, sp, _t1, t8 = _estimators(mode, "unpacked", funnel, 8)
    rp = _params(head_scale=0.05)[0]
    jc, _tc = _cfgs(mode)
    jc = dataclasses.replace(jc, **(FUNNEL if funnel else {}))
    j8 = JPose(mesh=box, cfg=jc, refiner_params=jax.tree.map(jnp.asarray, rp),
               scorer_params=jax.tree.map(jnp.asarray, sp), n_devices=8)
    np.testing.assert_allclose(t8.rot_grid.numpy(), np.asarray(j8.rot_grid), atol=1e-6)
    pj = j8.register(KF, *frame, iteration=2)
    pt = t8.register(KF, *frame, iteration=2)
    n = int(t8.hyp_valid.sum())
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t8.poses[:n].numpy(), np.asarray(j8.poses)[:n], atol=1e-4, rtol=0)


def test_sharded_register_follows_changes_to_the_estimator():
    """A mesh of two distinct devices ("cpu" and "cpu:1": the second shard
    runs on copies of the nets and the render mesh, as on a second card)
    against the unsharded estimator, through the changes a user makes
    between registers: weights loaded in place into the estimator's nets,
    then two new objects (reset_object + make_rotation_grid). Every
    register has the same order, poses and scores within 1e-4, and the
    weights' change moved the poses (the copies are made again)."""
    box, frame, _sp, t1, _ = _estimators("network", "unpacked", False, None)
    t2 = TPose(mesh=box, cfg=t1.cfg, refiner_params=copy.deepcopy(t1.refiner),
               scorer_params=copy.deepcopy(t1.scorer),
               device_mesh=tpar.make_device_mesh(devices=["cpu", "cpu:1"]))

    def both():
        p1 = t1.register(KF, *frame, iteration=2)
        p2 = t2.register(KF, *frame, iteration=2)
        _check_same_register(t1, t2, p1, p2, int(t1.hyp_valid.sum()))
        return t1.poses.clone()

    before = both()
    sd = t1.refiner.state_dict()
    sd = {k: -v if k.startswith(("trans_head.1", "rot_head.1")) else v for k, v in sd.items()}
    for e in (t1, t2):
        e.refiner.load_state_dict(sd)
    assert float((both() - before).abs().max()) > 1e-4
    for size in ((0.1, 0.14, 0.18), (0.12, 0.16, 0.2)):
        obj = _box()
        obj.vertices = obj.vertices * (np.array(size) / np.ptp(obj.vertices, axis=0))
        for e in (t1, t2):
            e.reset_object(mesh=obj)
            e.make_rotation_grid(min_n_views=e.cfg.min_n_views, inplane_step=e.cfg.inplane_step_deg)
        both()


def test_multitracker_from_sharded_estimator():
    """A sharded register hands over to MultiTracker on the mesh's first
    device, and tracks as from the unsharded estimator; track_one on the
    sharded estimator too."""
    box, frame, _sp, t1, t8 = _estimators("depth", "unpacked", False, 8)
    t1.register(KF, *frame, iteration=1)
    t8.register(KF, *frame, iteration=1)
    m1, m8 = TMulti.from_estimators([t1]), TMulti.from_estimators([t8])
    assert m8.device == t8.device_mesh.first
    nxt = _frame(box, t=(0.013, -0.018, 0.86))
    q1 = m1.track(nxt[0], nxt[1], KF, iteration=1)
    q8 = m8.track(nxt[0], nxt[1], KF, iteration=1)
    np.testing.assert_allclose(q8, q1, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t8.track_one(nxt[0], nxt[1], KF, iteration=1),
                               t1.track_one(nxt[0], nxt[1], KF, iteration=1), atol=1e-4, rtol=0)


@pytest.mark.slow
def test_multitracker_from_sharded_estimator_matches_jax():
    box, frame, _sp, _t1, t8 = _estimators("depth", "unpacked", False, 8)
    rp = _params(head_scale=0.05)[0]
    jc, _tc = _cfgs("depth")
    j8 = JPose(mesh=box, cfg=jc, refiner_params=jax.tree.map(jnp.asarray, rp), n_devices=8)
    j8.register(KF, *frame, iteration=1)
    t8.register(KF, *frame, iteration=1)
    nxt = _frame(box, t=(0.013, -0.018, 0.86))
    qj = JMulti.from_estimators([j8]).track(nxt[0], nxt[1], KF, iteration=1)
    qt = TMulti.from_estimators([t8]).track(nxt[0], nxt[1], KF, iteration=1)
    np.testing.assert_allclose(qt, qj, atol=1e-4, rtol=0)


# ------------------------------------------------------- data parallel

STEPS = 3
LR = 1e-4


def _dp_setup(kind):
    import test_torch_training as tt

    net_cfg, batch, p, net, jstep, tstep = tt.SETUPS[kind]()
    net.load_state_dict(params_from_jax(p, net.cfg))
    return net_cfg, batch, p, net, jstep, tstep, tt._tensors(batch)


def _grads(net):
    return {n: t.grad.clone() for n, t in net.state_dict(keep_vars=True).items() if t.grad is not None}


@pytest.mark.parametrize("kind,n_shards", [("refiner", 4), ("scorer", 8), ("scorer", 3)])
def test_dp_step_matches_unsharded(kind, n_shards):
    """3 f32 Adam steps, data-parallel over n CPU shards (3: uneven), from
    the same init as 3 unsharded steps: BN is inference-mode, so the two
    differ only in the order of the gradient's sum. Losses within
    TRAIN_LOSS_RTOL, every first-step gradient within 1e-4 of the largest
    (later steps start from parameters that Adam moved apart where the
    gradient is rounding noise), parameters (BN statistics included) by
    param_agreement."""
    _check_dp_against_unsharded(kind, tpar.make_device_mesh(n_shards, axis=tpar.DATA_AXIS, device="cpu"))


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_dp_step_on_copies_matches_unsharded(kind):
    """The same over a mesh of distinct devices ("cpu:1", "cpu", "cpu:2":
    the first and third shards run on copies of the net, as on other
    cards, and their gradients are added to the net's), 3 uneven shards:
    the copies are made again each step from the net's current values."""
    _check_dp_against_unsharded(kind, tpar.make_device_mesh(axis=tpar.DATA_AXIS,
                                                            devices=["cpu:1", "cpu", "cpu:2"]))


def _check_dp_against_unsharded(kind, mesh):
    _net_cfg, _batch, _p, net, _jstep, tstep, tb = _dp_setup(kind)
    net_dp = copy.deepcopy(net)
    cfg = ttr.TrainCfg(lr=LR, compute_dtype="float32")
    opt = ttr.make_optimizer(cfg, net, device="cpu")
    opt_dp = ttr.make_optimizer(cfg, net_dp, device="cpu")
    grads = []
    for step in range(STEPS):
        loss = tstep(net, opt, cfg, tb)
        grads.append(_grads(net))
        loss_dp = tstep(net_dp, opt_dp, cfg, tb, mesh=mesh)
        assert loss_dp.ndim == 0 and not loss_dp.requires_grad
        np.testing.assert_allclose(float(loss_dp), float(loss), rtol=TRAIN_LOSS_RTOL)
        g_dp = _grads(net_dp)
        assert g_dp.keys() == grads[-1].keys()
        assert any(k.endswith("running_var") for k in g_dp)  # BN statistics are summed too
        gmax = max(float(g.abs().max()) for g in grads[-1].values())
        for k, g in grads[-1].items():
            if step == 0:
                np.testing.assert_allclose(g_dp[k].numpy(), g.numpy(), atol=1e-4 * gmax, rtol=0,
                                           err_msg=k)
    agree = param_agreement(net_dp.state_dict(), net.state_dict(), grads, LR)
    assert agreement_ok(*agree), agree


def test_dp_scorer_gradient_flows_through_the_gather():
    """The scorer's group spans the shards: each shard's trunk gets its
    gradient back through the gathered pooled features (the cross
    attention mixes all 8 hypotheses). One shard a hypothesis, each on a
    copy of the net ("cpu:0" to "cpu:7" are distinct mesh devices, as 8
    cards would be); each replica's trunk gradient is nonzero, and the
    summed gradient of every trunk tensor matches the unsharded one within
    1e-4 of its largest."""
    _net_cfg, _batch, _p, net, _jstep, _tstep, tb = _dp_setup("scorer")
    net_dp = copy.deepcopy(net)
    cfg = ttr.TrainCfg(lr=LR, compute_dtype="float32")
    opt = ttr.make_optimizer(cfg, net, device="cpu")
    opt_dp = ttr.make_optimizer(cfg, net_dp, device="cpu")
    ttr.score_train_step(net, opt, cfg, tb)
    seen = []
    orig = ttr._dp_step

    def spy(module, optimizer, mesh, batch, loss_of):
        def wrapped(reps, shards):
            loss = loss_of(reps, shards)
            loss.backward(retain_graph=True)
            seen.extend(float(r.encoderA[0].net[0].weight.grad.abs().max()) for r in reps)
            for r in reps:
                for t in ttr._trained(r):
                    t.grad = None
            return loss
        return orig(module, optimizer, mesh, batch, wrapped)

    ttr._dp_step = spy
    try:
        ttr.score_train_step(net_dp, opt_dp, cfg, tb,
                             mesh=tpar.make_device_mesh(devices=[f"cpu:{i}" for i in range(8)]))
    finally:
        ttr._dp_step = orig
    assert len(seen) == 8 and min(seen) > 0 and len(set(seen)) > 1
    g, g_dp = _grads(net), _grads(net_dp)
    for k in g:
        if k.startswith("encoder"):
            top = float(g[k].abs().max())
            np.testing.assert_allclose(g_dp[k].numpy(), g[k].numpy(), atol=1e-4 * top + 1e-12, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("kind,n_shards", [("refiner", 4), ("scorer", 8)])
def test_dp_step_matches_jax_data_mesh(kind, n_shards):
    """The port's data-parallel steps against the JAX package's train
    steps on a batch sharded over a "data" mesh of the same size
    (tests/test_sharding.py's DP tests, there only "params moved"):
    losses within TRAIN_LOSS_RTOL, parameters by param_agreement."""
    net_cfg, batch, p, net, jstep, tstep, tb = _dp_setup(kind)
    import test_torch_training as tt

    cfg_kw = dict(lr=LR, compute_dtype="float32")
    jcfg, tcfg = jtr.TrainCfg(**cfg_kw), ttr.TrainCfg(**cfg_kw)
    opt = ttr.make_optimizer(tcfg, net, device="cpu")
    mj = jpar.make_device_mesh(n_shards, axis="data")
    sh = jpar.batch_sharding(mj)
    batch_sh = {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}
    jp = jpar.replicate_tree(jax.tree.map(jnp.asarray, p), mj)
    jo = jpar.replicate_tree(jtr.make_optimizer(jcfg).init(jax.tree.map(jnp.asarray, p)), mj)
    grad = jax.jit(jax.grad(tt._jax_loss(kind, net_cfg, jcfg.loss_type)))
    mesh = tpar.make_device_mesh(n_shards, axis=tpar.DATA_AXIS, device="cpu")
    grads = []
    for _ in range(STEPS):
        grads.append(params_from_jax(jax.tree.map(np.asarray, grad(jp, batch_sh)), net.cfg))
        jp, jo, lj = jstep(jp, jo, net_cfg, jcfg, batch_sh)
        lt = tstep(net, opt, tcfg, tb, mesh=mesh)
        np.testing.assert_allclose(float(lt), float(lj), rtol=TRAIN_LOSS_RTOL)
    tt._assert_params_match(net, jp, grads, LR)
