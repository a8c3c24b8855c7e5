"""The port's `parallel/` helpers and its data-parallel train steps
against foundationpose_tpu.parallel on the same numpy inputs: the
helpers bit-equal, the device mesh and its replicas, and the
data-parallel refiner and scorer steps against unsharded steps and
against the JAX package's steps on a "data" mesh.

A mesh of 8 CPU shards stands in for the JAX package's 8 virtual host
devices (tests/conftest.py). f32 on both sides. Train steps are held by
tests/test_torch_training.py's bounds (losses relative
chip_smoke.TRAIN_LOSS_RTOL, parameters by chip_smoke.param_agreement).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_LOSS_RTOL, agreement_ok, param_agreement
from foundationpose_tpu import parallel as jpar
from foundationpose_tpu.models import training as jtr
from foundationpose_torch import parallel as tpar
from foundationpose_torch.models import training as ttr
from foundationpose_torch.models.convert import params_from_jax
from test_torch_pipeline import _hyp_poses

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
    x = torch.arange(16.0).reshape(8, 2)
    parts = tpar.batch_sharding(m)(x)
    assert [p.shape for p in parts] == [(4, 2), (4, 2)] and torch.equal(torch.cat(parts), x)
    assert all(torch.equal(r, x) for r in tpar.replicated(m)(x))
    with pytest.raises(ValueError):
        tpar.batch_sharding(CPU8)(x[:5])
    with pytest.raises(ValueError):
        tpar.batch_sharding(m, axis="hyp")


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
