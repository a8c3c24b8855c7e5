"""The port's training path (foundationpose_torch/models/training.py and
the differentiable attention core) against foundationpose_tpu.

Train steps run in f32 on both sides (the bf16 layers round their bias
adds otherwise, a deliberate difference bounded layer by layer in
tests/test_torch_networks.py), from `params_from_jax` of one JAX init and
on one batch made by the JAX package. Bounds, stated where they are used:
- the attention core's gradient against jax.vjp: 1e-6 f32, 1e-3 bf16
  (below one bf16 ulp at 0.5);
- first-step gradients, every leaf (BN statistics included): within
  1e-4 of the largest gradient;
- losses per step: relative chip_smoke.TRAIN_LOSS_RTOL (5e-5);
- parameters after the steps, every leaf: chip_smoke.param_agreement.
  Adam moves an entry by ~lr whatever its gradient's size, so where the
  gradient is rounding noise two runs may step apart. At least half the
  entries must be resolved (a gradient clear of the noise at every step)
  and agree within 0.1 lr a step there (seen: 1.3e-3), every entry within
  Adam's reach of 2.1 lr a step (seen: 1.9), each after 4 f32 roundings
  of the parameter a step. chip_smoke.py holds the card against the CPU
  by the same bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.datasets import synthetic as jsyn
from foundationpose_tpu.models import networks as jnet
from foundationpose_tpu.models import training as jtr
from foundationpose_tpu.ops.attention import attention_core as j_attention
from foundationpose_tpu.pipeline import RasterCfg as JRaster
from foundationpose_tpu.pipeline import RefinerCfg as JRef
from foundationpose_tpu.pipeline import ScorerCfg as JSco
from foundationpose_tpu.pipeline import make_mesh_tensors as j_mesh
from foundationpose_torch.datasets import make_refiner_batch, make_scorer_batch, sample_pose_pairs
from foundationpose_torch.models import networks as tnet
from foundationpose_torch.models import training as ttr
from foundationpose_torch.models.convert import opt_state_from_jax, params_from_jax, params_to_jax
from foundationpose_torch.ops import attention_cuda
from foundationpose_torch.ops.attention import attention_core
from foundationpose_torch.pipeline import RefinerCfg as TRef
from foundationpose_torch.pipeline import ScorerCfg as TSco
from foundationpose_torch.pipeline import make_mesh_tensors as t_mesh
from chip_smoke import TRAIN_LOSS_RTOL, agreement_ok, param_agreement, spread_scorer
from tests.test_pipeline import K, colored_box

LR = 1e-4  # TrainCfg's; at 1e-3 one step undoes the scorer's spread (its logits tie again)
STEPS = 3


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,D,H", [(2, 20, 64, 4), (3, 37, 64, 4), (2, 24, 256, 2)])
def test_attention_core_grad_matches_jax_vjp(dtype, B, L, D, H):
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    xj = jnp.asarray(rng.uniform(-1, 1, (B, L, 3 * D)), jdt)
    gj = jnp.asarray(rng.normal(size=(B, L, D)), jdt)
    out_j, vjp = jax.vjp(lambda t: j_attention(t, H), xj)
    (dx_j,) = vjp(gj)
    as_t = lambda a: torch.as_tensor(np.asarray(a.astype(jnp.float32))).to(tdt)  # noqa: E731
    x = as_t(xj).requires_grad_(True)
    out = attention_core(x, H)
    assert out.grad_fn is not None and out.dtype == tdt
    out.backward(as_t(gj))
    tol = 1e-6 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(out_j, np.float32),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(dx_j, np.float32),
                               atol=tol, rtol=0)


def test_attention_kernel_refuses_a_qkv_that_needs_a_gradient():
    """The kernel's output carries no gradient; a direct call with a qkv
    that needs one raises (only the autograd.Function may call it then)."""
    qkv = torch.zeros(1, 4, 24, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        attention_cuda.attention_core_cuda(qkv, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        attention_cuda.attention_core_cuda(qkv, 2)
    with torch.no_grad():
        assert attention_core(qkv, 2).grad_fn is None


# ------------------------------------------------------------ set-up


def _mesh():
    mesh = colored_box()
    return mesh, j_mesh(mesh)


def _refiner_setup(seed=1):
    jc = JRef(net=jnet.RefineNetCfg(base_width=4), compute_dtype="float32", input_res=32,
              raster=JRaster(method="brute"))
    _mesh_, mj = _mesh()
    b = jsyn.make_refiner_batch(jax.random.PRNGKey(0), mj, jnp.asarray(K), jc, jnp.float32(0.28),
                                n=4, frame_hw=(120, 160))
    batch = {k: b[k] for k in ("A", "B", "trans_target", "rot_target")}
    p = jax.tree.map(np.asarray, jnet.init_refine_net(jax.random.PRNGKey(seed), jc.net))
    net = tnet.RefineNet(tnet.RefineNetCfg(base_width=4))
    return jc.net, batch, p, net, jtr.refine_train_step, ttr.refine_train_step


def _scorer_setup(seed=2):
    """A random narrow ScoreNet gives every hypothesis the same logit
    within ~1e-6, so its gradients are rounding noise;
    chip_smoke.spread_scorer reshapes it so that each logit follows its
    hypothesis's features."""
    jc = JSco(net=jnet.ScoreNetCfg(base_width=4), input_res=32, mode="network",
              compute_dtype="float32", raster=JRaster(method="brute"))
    _mesh_, mj = _mesh()
    b = jsyn.make_scorer_batch(jax.random.PRNGKey(1), mj, jnp.asarray(K), jc, jnp.float32(0.28),
                               n=8, frame_hw=(120, 160))
    batch = {k: b[k] for k in ("A", "B", "target")}
    p = jax.tree.map(np.asarray, jnet.init_score_net(jax.random.PRNGKey(seed), jc.net))
    net = tnet.ScoreNetMultiPair(tnet.ScoreNetCfg(base_width=4))
    net.load_state_dict(params_from_jax(p, net.cfg))
    spread_scorer(net, *(torch.as_tensor(np.array(batch[k])) for k in ("A", "B")))
    return jc.net, batch, params_to_jax(net.state_dict()), net, jtr.score_train_step, \
        ttr.score_train_step


SETUPS = {"refiner": _refiner_setup, "scorer": _scorer_setup}


def _jax_loss(kind, net_cfg, loss_type="l2"):
    if kind == "refiner":
        return lambda q, b: jtr.refine_loss_fn(q, net_cfg, b, loss_type, jnp.float32)
    return lambda q, b: jtr.score_loss_fn(q, net_cfg, b, jnp.float32)


def _leaves(tree):
    return {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tensors(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _run_both(kind, net_cfg, batch, jp, jo, jstep, net, opt, tstep, jcfg, tcfg, steps):
    """`steps` steps on each side; checks each loss and returns the JAX
    params, optax state and gradients of each step (as state_dicts)."""
    grad = jax.jit(jax.grad(_jax_loss(kind, net_cfg, jcfg.loss_type)))
    tb, grads = _tensors(batch), []
    for _ in range(steps):
        grads.append(params_from_jax(jax.tree.map(np.asarray, grad(jp, batch)), net.cfg))
        jp, jo, lj = jstep(jp, jo, net_cfg, jcfg, batch)
        lt = tstep(net, opt, tcfg, tb)
        assert lt.ndim == 0 and not lt.requires_grad
        np.testing.assert_allclose(float(lt), float(lj), rtol=TRAIN_LOSS_RTOL)
    return jp, jo, grads


def _assert_params_match(net, jp, grads, lr):
    """Every leaf, BN mean / var included, by chip_smoke.param_agreement."""
    want = params_from_jax(jax.tree.map(np.asarray, jp), net.cfg)
    assert net.state_dict().keys() == want.keys()
    assert any(k.endswith("running_mean") for k in want) == net.cfg.use_bn
    agree = param_agreement(net.state_dict(), want, grads, lr)
    assert agreement_ok(*agree), agree


# ------------------------------------------------------------ steps


def test_first_step_gradients_match_jax():
    """One loss and its gradient on every leaf, BN statistics included,
    for both nets."""
    for kind, setup in SETUPS.items():
        net_cfg, batch, p, net, _jstep, _tstep = setup()
        net.load_state_dict(params_from_jax(p, net.cfg))
        ttr.make_optimizer(ttr.TrainCfg(), net, device="cpu")
        tb = _tensors(batch)
        jl = _jax_loss(kind, net_cfg)
        loss = (ttr.refine_loss_fn(net, tb, "l2", torch.float32) if kind == "refiner"
                else ttr.score_loss_fn(net, tb, torch.float32))
        lj, gj = jax.jit(jax.value_and_grad(jl))(jax.tree.map(jnp.asarray, p), batch)
        loss.backward()
        np.testing.assert_allclose(float(loss), float(lj), rtol=TRAIN_LOSS_RTOL)
        grads = {n: t.grad for n, t in net.state_dict(keep_vars=True).items() if t.grad is not None}
        gt, gj = _leaves(params_to_jax({**net.state_dict(), **grads})), _leaves(gj)
        gmax = max(np.abs(a).max() for a in gj.values())
        for k, a in gj.items():
            np.testing.assert_allclose(gt[k], a, atol=1e-4 * gmax, rtol=0, err_msg=str((kind, k)))


CASES = [("refiner", "l2", 0.0), ("refiner", "l1", 0.0), ("refiner", "l2", 1e-2),
         ("refiner", "l1", 1e-2), ("scorer", "l2", 0.0), ("scorer", "l2", 1e-2)]


@pytest.mark.parametrize("kind,loss_type,weight_decay", CASES)
def test_train_steps_match_jax(kind, loss_type, weight_decay):
    """3 f32 steps of Adam (weight_decay 0) or AdamW from one JAX init."""
    net_cfg, batch, p, net, jstep, tstep = SETUPS[kind]()
    kw = dict(lr=LR, weight_decay=weight_decay, loss_type=loss_type, compute_dtype="float32")
    jcfg, tcfg = jtr.TrainCfg(**kw), ttr.TrainCfg(**kw)
    net.load_state_dict(params_from_jax(p, net.cfg))
    opt = ttr.make_optimizer(tcfg, net, device="cpu")
    assert isinstance(opt, torch.optim.AdamW if weight_decay else torch.optim.Adam)
    jp = jax.tree.map(jnp.asarray, p)
    jo = jtr.make_optimizer(jcfg).init(jp)
    jp, _jo, grads = _run_both(kind, net_cfg, batch, jp, jo, jstep, net, opt, tstep, jcfg, tcfg,
                               STEPS)
    _assert_params_match(net, jp, grads, LR)


@pytest.mark.parametrize("kind,weight_decay", [("refiner", 0.0), ("scorer", 1e-2)])
def test_resume_from_jax_opt_state(kind, weight_decay):
    """2 JAX steps, then the JAX params and optax state carried into the
    port (`params_from_jax`, `opt_state_from_jax`): the next step of each
    package agrees. Adam's chain and AdamW's differ in layout."""
    net_cfg, batch, p, net, jstep, tstep = SETUPS[kind]()
    kw = dict(lr=LR, weight_decay=weight_decay, compute_dtype="float32")
    jcfg, tcfg = jtr.TrainCfg(**kw), ttr.TrainCfg(**kw)
    jp = jax.tree.map(jnp.asarray, p)
    jo = jtr.make_optimizer(jcfg).init(jp)
    for _ in range(2):
        jp, jo, _l = jstep(jp, jo, net_cfg, jcfg, batch)
    p2 = jax.tree.map(np.asarray, jp)
    net.load_state_dict(params_from_jax(p2, net.cfg))
    opt = ttr.make_optimizer(tcfg, net, device="cpu")
    opt.load_state_dict(opt_state_from_jax(jax.tree.map(np.asarray, jo), net, opt))
    assert all(float(s["step"]) == 2 for s in opt.state.values())
    jp, _jo, grads = _run_both(kind, net_cfg, batch, jp, jo, jstep, net, opt, tstep, jcfg, tcfg, 1)
    _assert_params_match(net, jp, grads, LR)


def test_bn_statistics_are_trained_under_their_state_dict_names():
    """The optimizer holds every parameter and every BN running mean and
    variance (the JAX package's `mean` / `var` leaves), not
    num_batches_tracked; the state_dict keeps its names, so
    load_torch_state_dict and params_to_jax read a trained net."""
    net = tnet.RefineNet(tnet.RefineNetCfg(base_width=4))
    keys = list(net.state_dict())
    opt = ttr.make_optimizer(ttr.TrainCfg(), net, device="cpu")
    assert list(net.state_dict()) == keys
    held = {id(t) for g in opt.param_groups for t in g["params"]}
    sd = net.state_dict(keep_vars=True)
    want = {n for n in sd if not n.endswith("num_batches_tracked")}
    assert {n for n, t in sd.items() if id(t) in held} == want
    assert all(sd[n].requires_grad and sd[n].is_leaf for n in want)
    ttr.make_optimizer(ttr.TrainCfg(), net, device="cpu")  # again: still leaves
    assert all(t.is_leaf for t in net.state_dict(keep_vars=True).values())
    params_from_jax(params_to_jax(net.state_dict()), net.cfg)


def test_step_reaches_every_tensor_and_returns_a_device_loss():
    """One refiner step from a port init: every trained tensor, BN
    statistics included, has a finite gradient, the in-projections a
    non-zero one (what the kernel would drop without the
    autograd.Function), and the step moves the BN statistics."""
    mt = t_mesh(colored_box())
    cfg = TRef(net=tnet.RefineNetCfg(base_width=4), input_res=32, compute_dtype="float32")
    net = tnet.init_refine_net(cfg.net, torch.Generator().manual_seed(0))
    opt = ttr.make_optimizer(ttr.TrainCfg(compute_dtype="float32"), net, device="cpu")
    before = {n: t.detach().clone() for n, t in net.state_dict().items()}
    batch = make_refiner_batch(0, mt, torch.as_tensor(K), cfg, 0.28, n=4)
    loss = ttr.refine_train_step(net, opt, ttr.TrainCfg(compute_dtype="float32"), batch)
    assert loss.device.type == "cpu" and torch.isfinite(loss)
    sd = net.state_dict(keep_vars=True)
    for n, t in sd.items():
        if n.endswith("num_batches_tracked"):
            continue
        assert t.grad is not None and torch.isfinite(t.grad).all(), n
    for n in ("trans_head.0.self_attn.in_proj_weight", "rot_head.0.self_attn.in_proj_weight"):
        assert float(sd[n].grad.abs().max()) > 0, n
    assert not torch.equal(before["encodeA.0.net.1.running_mean"], sd["encodeA.0.net.1.running_mean"])


def test_loss_decreases_on_synthetic_batch():
    """TestRefinerTraining: 8 f32 steps on one port batch lower the loss."""
    mt = t_mesh(colored_box())
    cfg = TRef(net=tnet.RefineNetCfg(base_width=4), compute_dtype="float32")
    batch = make_refiner_batch(0, mt, torch.as_tensor(K), cfg, 0.3, n=4)
    assert torch.isfinite(batch["A"]).all() and torch.isfinite(batch["trans_target"]).all()
    assert float((batch["A"] - batch["B"]).abs().mean()) > 1e-4
    net = tnet.init_refine_net(cfg.net, torch.Generator().manual_seed(1))
    tcfg = ttr.TrainCfg(lr=1e-3, compute_dtype="float32")
    opt = ttr.make_optimizer(tcfg, net, device="cpu")
    train = {k: batch[k] for k in ("A", "B", "trans_target", "rot_target")}
    losses = [float(ttr.refine_train_step(net, opt, tcfg, train)) for _ in range(8)]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttr.make_optimizer(ttr.TrainCfg(), tnet.RefineNet(tnet.RefineNetCfg(base_width=4)))


# ------------------------------------------------------------ convergence (slow)


KD = 0.28  # the box's diameter, as the JAX tests use it


def _port_frame(mesh, pose, hw=(240, 320)):
    from foundationpose_torch.ops.rasterizer import render_mesh

    mt = t_mesh(mesh)
    out = render_mesh(mt.pos, mt.faces, torch.as_tensor(pose[None], dtype=torch.float32),
                      torch.as_tensor(K), out_hw=hw, vertex_color=mt.vertex_color, uv=mt.uv,
                      tex=mt.tex, vnormals=mt.vnormals, use_light=True)
    return ((out.color[0].numpy() * 255).astype(np.uint8), out.depth[0].numpy().astype(np.float32),
            out.mask[0].numpy().astype(np.uint8))


def train_estimator_nets(mesh, diameter, scene_seed, *, r_steps=250, s_steps=250, base_width=8,
                         input_res=64, occlude_prob=0.0, device="cpu"):
    """The mid-width synthetic recipe of tests/test_training.py: a refiner
    trained with rot_sigma 0.25 and trans_sigma 0.05 (hypotheses at half
    the rotation grid's spacing and the translation guess's error), then
    a scorer on a fixed scene (the gt pose pinned by scene_seed).
    Returns (rcfg, refiner, scfg, scorer, scorer losses)."""
    from foundationpose_torch.models import ScoreNetCfg, init_refine_net, init_score_net

    mt = t_mesh(mesh, device=device)
    Kt = torch.as_tensor(K, device=device)
    rcfg = TRef(net=tnet.RefineNetCfg(base_width=base_width), compute_dtype="float32",
                input_res=input_res)
    refiner = init_refine_net(rcfg.net, torch.Generator().manual_seed(7))
    tcfg = ttr.TrainCfg(lr=1e-3, compute_dtype="float32")
    opt = ttr.make_optimizer(tcfg, refiner, device=device)
    for step in range(r_steps):
        b = make_refiner_batch(100 + step, mt, Kt, rcfg, diameter, n=16, rot_sigma=0.25,
                               trans_sigma=0.05, occlude_prob=occlude_prob)
        rloss = ttr.refine_train_step(refiner, opt, tcfg, b)
    assert np.isfinite(float(rloss))

    scfg = TSco(net=ScoreNetCfg(base_width=base_width), input_res=input_res, mode="network",
                compute_dtype="float32")
    scorer = init_score_net(scfg.net, torch.Generator().manual_seed(8))
    stcfg = ttr.TrainCfg(lr=3e-4, compute_dtype="float32")
    sopt = ttr.make_optimizer(stcfg, scorer, device=device)
    slosses = []
    for step in range(s_steps):
        sb = make_scorer_batch(5000 + step, mt, Kt, scfg, diameter, n=16, frame_hw=(240, 320),
                               scene_seed=scene_seed, occlude_prob=occlude_prob)
        slosses.append(ttr.score_train_step(scorer, sopt, stcfg, sb))
    return rcfg, refiner, scfg, scorer, [float(x) for x in slosses]


@pytest.mark.slow
class TestRefinerLearnsToRefine:
    def test_trained_refiner_reduces_pose_error(self):
        """A small refiner trained on synthetic pairs lowers the pose error
        of held-out perturbations through refine_poses."""
        from foundationpose_torch.geometry.projection import depth_to_xyz_map
        from foundationpose_torch.models import init_refine_net
        from foundationpose_torch.pipeline.refiner import refine_poses
        from foundationpose_torch.utils.metrics import add_err

        mesh = colored_box()
        mt = t_mesh(mesh)
        Kt = torch.as_tensor(K)
        cfg = TRef(net=tnet.RefineNetCfg(base_width=8), compute_dtype="float32", input_res=64)
        net = init_refine_net(cfg.net, torch.Generator().manual_seed(7))
        tcfg = ttr.TrainCfg(lr=1e-3, compute_dtype="float32")
        opt = ttr.make_optimizer(tcfg, net, device="cpu")
        for step in range(150):
            loss = ttr.refine_train_step(
                net, opt, tcfg, make_refiner_batch(100 + step, mt, Kt, cfg, KD, n=16))
        assert np.isfinite(float(loss))

        poseA, poseB = sample_pose_pairs(999, 8, device="cpu")
        before, after = [], []
        for i in range(8):
            gt = poseB[i].numpy()
            rgb, depth, _mask = _port_frame(mesh, gt, (120, 160))
            xyz = depth_to_xyz_map(torch.as_tensor(depth), Kt)
            with torch.no_grad():
                refined = refine_poses(net, cfg, mt, poseA[i:i + 1], Kt,
                                       torch.as_tensor(rgb).float() / 255.0, xyz, KD,
                                       iterations=1)
            before.append(add_err(poseA[i].numpy(), gt, mesh.vertices))
            after.append(add_err(refined[0].numpy(), gt, mesh.vertices))
        assert np.mean(after) < np.mean(before)


def _register(mesh, rcfg, refiner, scfg, scorer, frame, gt, mode="network", fast=False):
    from foundationpose_torch.pipeline import EstimatorCfg, FoundationPose
    from foundationpose_torch.utils.metrics import adds_err

    cfg = EstimatorCfg(refiner=rcfg, scorer=dataclasses.replace(scfg, mode=mode))
    if fast:
        cfg = cfg.fast_register()
    est = FoundationPose(mesh=mesh, cfg=cfg, refiner_params=refiner,
                         scorer_params=scorer if mode == "network" else None, device="cpu")
    est.gt_pose = gt
    pose = est.register(K, *frame, iteration=5)
    errs = est.compute_add_err_to_gt_pose(np.asarray(est.poses.cpu()))
    rank = int(np.where(np.argsort(errs) == 0)[0][0])
    return adds_err(pose, gt, mesh.vertices), rank


@pytest.mark.slow
class TestTrainedNetworkRegistration:
    def test_network_scored_registration_beats_depth(self):
        """Train a tiny refiner and scorer, then register with the network
        scorer: it ranks held-out groups, lands within 6 cm ADD-S, no
        worse than the depth scorer, and the funneled register stays
        within 2 mm of the full one (the JAX test's bars)."""
        mesh = colored_box()
        mt = t_mesh(mesh)
        Kt = torch.as_tensor(K)
        rcfg, refiner, scfg, scorer, slosses = train_estimator_nets(mesh, KD, scene_seed=42)
        assert np.mean(slosses[-20:]) < np.mean(slosses[:20]) - 0.15

        sb = make_scorer_batch(777, mt, Kt, scfg, KD, n=16, frame_hw=(240, 320), scene_seed=42)
        with torch.no_grad():
            logits = scorer(sb["A"], sb["B"], dtype=torch.float32).numpy()
        adds = sb["add"].numpy()
        assert adds[np.argmax(logits)] <= np.partition(adds, 2)[2]
        assert np.corrcoef(logits, -adds)[0, 1] > 0.5

        gt = sb["gt"].numpy()
        frame = _port_frame(mesh, gt)
        err_net, rank_net = _register(mesh, rcfg, refiner, scfg, scorer, frame, gt)
        err_depth, _ = _register(mesh, rcfg, refiner, scfg, scorer, frame, gt, mode="depth")
        assert err_net < 0.06, f"network-scored ADD-S {err_net}"
        assert err_net <= err_depth + 0.005, (err_net, err_depth)
        assert rank_net <= 3, rank_net
        err_p, _ = _register(mesh, rcfg, refiner, scfg, scorer, frame, gt, fast=True)
        assert err_p < 0.06, f"funneled ADD-S {err_p}"
        assert err_p <= err_net + 0.002, (err_p, err_net)


@pytest.mark.slow
class TestFunneledRegisterBreadth:
    """The funneled register within 2 mm of the full one on a textured
    bumpy icosphere and on the box under clutter and occlusion (the JAX
    suite's two scenes, with nets trained by the port)."""

    def _gate(self, mesh, frame, gt, nets, pts):
        from foundationpose_torch.pipeline import EstimatorCfg, FoundationPose
        from foundationpose_torch.utils.metrics import adds_err

        rcfg, refiner, scfg, scorer, _l = nets
        cfg = EstimatorCfg(refiner=rcfg, scorer=scfg)
        errs = []
        for c in (cfg, cfg.fast_register()):
            est = FoundationPose(mesh=mesh, cfg=c, refiner_params=refiner, scorer_params=scorer,
                                 device="cpu")
            errs.append(adds_err(est.register(K, *frame, iteration=5), gt, pts))
        return errs

    def test_textured_icosphere_scene(self):
        from foundationpose_torch.geometry.icosphere import icosphere
        from foundationpose_torch.meshio import TriMesh

        verts, faces = icosphere(3, radius=0.1)
        rng = np.random.default_rng(3)
        verts = verts * (1.0 + 0.15 * np.sin(8 * verts[:, 2:3]))
        nrm = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
        uv = np.stack([np.arctan2(nrm[:, 1], nrm[:, 0]) / (2 * np.pi) + 0.5,
                       nrm[:, 2] * 0.5 + 0.5], axis=-1).astype(np.float32)
        tex = rng.integers(30, 255, size=(128, 128, 3)).astype(np.uint8)
        mesh = TriMesh(vertices=verts, faces=faces, uv=uv, texture=tex)
        diameter = float(np.float32(np.linalg.norm(verts.max(0) - verts.min(0))))
        nets = train_estimator_nets(mesh, diameter, scene_seed=21)
        sb = make_scorer_batch(777, t_mesh(mesh), torch.as_tensor(K), nets[2], diameter, n=4,
                               frame_hw=(240, 320), scene_seed=21)
        gt = sb["gt"].numpy()
        err_full, err_p = self._gate(mesh, _port_frame(mesh, gt), gt, nets, verts)
        assert err_full < 0.06, err_full
        assert abs(err_p - err_full) <= 0.002, (err_p, err_full)

    def test_cluttered_occluded_scene(self):
        from foundationpose_torch.meshio import make_box

        mesh = colored_box()
        nets = train_estimator_nets(mesh, KD, scene_seed=42, occlude_prob=0.5)
        sb = make_scorer_batch(77, t_mesh(mesh), torch.as_tensor(K), nets[2], KD, n=4,
                               frame_hw=(240, 320), scene_seed=42)
        gt = sb["gt"].numpy()
        H_, W_ = 240, 320
        rgb = np.zeros((H_, W_, 3), np.uint8)
        depth = np.full((H_, W_), np.inf, np.float32)
        owner = np.zeros((H_, W_), np.int32)  # 0 background, 1 target, 2+ other

        def paste(m, pose, who):
            c, d, msk = _port_frame(m, pose)
            front = msk.astype(bool) & (np.where(msk, d, np.inf) < depth)
            rgb[front], depth[front], owner[front] = c[front], d[front], who

        paste(mesh, gt, 1)
        full_px = int((owner == 1).sum())
        rng = np.random.default_rng(11)
        for j, dx in enumerate((-0.16, 0.17)):
            clutter = make_box(np.array([0.08, 0.1, 0.07]))
            clutter.vertex_colors = rng.integers(40, 255, size=(8, 3)).astype(np.uint8)
            pc = gt.copy()
            pc[0, 3] += dx
            pc[1, 3] += 0.02 * (-1) ** j
            paste(clutter, pc, 2 + j)
        occ = make_box(np.array([0.05, 0.3, 0.01]))
        occ.vertex_colors = np.full((8, 3), 200, np.uint8)
        po = np.eye(4, dtype=np.float32)
        po[:3, 3] = [gt[0, 3] - 0.065, gt[1, 3], gt[2, 3] - 0.25]
        paste(occ, po, 4)
        depth[np.isinf(depth)] = 0.0
        mask = (owner == 1).astype(np.uint8)
        assert 0.5 * full_px < mask.sum() < 0.92 * full_px, (mask.sum(), full_px)
        err_full, err_p = self._gate(mesh, (rgb, depth, mask), gt, nets, mesh.vertices)
        assert err_full < 0.06, err_full
        assert abs(err_p - err_full) <= 0.002, (err_p, err_full)
