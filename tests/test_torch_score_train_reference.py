"""The scorer's train step against the benchmark's plain f32 reference
(benchmark/reference/score_train.py) on the CPU, at a small cut of the
cell train-scorer (base width 8, 32x32 crops, a 160x120 frame, a group of
6 hypotheses, f32): the cell's driver builds the net from the seeded,
shaped weights and runs its 3 warm steps through `make_scorer_batch` and
`score_train_step`; the reference follows them from the same weights and
draws; the check's window step compares the forward the program ran
(pooled features, logits) with the reference's. Also: a scorer step is one recorder request whose device stages
are `score_train.trunk`, `score_train.attention`, `train.backward` and
`train.adam` (a refiner step's `train.forward`, `train.backward`,
`train.adam`), its loss bit-equal to the one the net's `forward` gives,
and the reference imports nothing of the program or of JAX."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import score_train as driver
from benchmark.drivers.nerf import step_dists
from benchmark.drivers.train import B1
from benchmark.reference import score_train as ref
from foundationpose_torch.models import networks as tnet
from foundationpose_torch.models import training
from foundationpose_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 11
CUT = dict(base_width=8, input_res=32, frame_height=120, frame_width=160, fx=140.0, fy=140.0,
           compute_dtype="float32")
# f32 on both sides: the same products and sums in another order.
LOSS_TOL = 1e-5  # each step's loss, relative (read: 4e-7)
GRAD_TOL = 1e-4  # the first gradient, each leaf's |prog - ref| over the larger of its and the median leaf's norm (1.4e-5)
# The change after 3 steps over the entries step_gaps resolves: Adam steps each
# entry by about lr whatever its gradient's size, so entries whose gradient is
# rounding noise (the logit's bias, the keys' and the cross-attention values'
# biases, under a softmax's shift invariance) move either way and are left out.
UPDATE_TOL = 1e-4  # median leaf's distance (6e-6)
UPDATE_WORST_TOL = 1e-3  # worst leaf's distance (1.6e-4)
FEAT_TOL = 1e-5  # the window step's features and logits, relative (0 here: the same f32 forward)
STAGES = {"score": ["score_train.trunk", "score_train.attention", "train.backward", "train.adam"],
          "refine": ["train.forward", "train.backward", "train.adam"]}


def _cut():
    cell = harness.find_cell(harness.manifest(), "train-scorer")
    cfg, tr = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    return dict(cfg, **CUT, mesh=dict(cfg["mesh"], subdivisions=2)), dict(tr, group=6, frame_hw=[120, 160])


@pytest.fixture(scope="module")
def run():
    """The cut cell's driver after its warm steps, and the reference's
    batches of the same draws."""
    d = driver.Driver(*_cut(), SEED, torch.device("cpu"))
    return d, [d._ref_batch(x) for x in d.draws]


def test_batch_matches_the_reference(run):
    from foundationpose_torch.datasets import make_scorer_batch

    d, batches = run
    t = d.tr
    for draws, want in zip(d.draws, batches):
        got = make_scorer_batch(None, d.mt, d.Kt, d.scfg, d.diam, n=d.n, frame_hw=tuple(t["frame_hw"]),
                                rot_sigma=t["rot_sigma"], trans_sigma=t["trans_sigma"], draws=draws)
        for k in ("A", "B", "target"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5, msg=k)


def _gaps(losses, grad, moved, ref_losses, ref_grad, ref_moved) -> dict:
    """The change over the leaves the reference moved: the BN variances of
    1e4 that the shaping leaves stay put in f32 under a step of 1e-4, on
    both sides (held by `still` in the program's case)."""
    norms = {k: float(torch.linalg.norm(g)) for k, g in ref_grad.items()}
    median = float(torch.tensor(list(norms.values())).median())
    kept = [k for k, r in ref_moved.items() if bool(r.any())]
    dist = step_dists(*({k: x[k] for k in kept} for x in (grad, ref_grad, moved, ref_moved)))
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad": max(float(torch.linalg.norm(grad[k] - g)) / max(norms[k], median) for k, g in ref_grad.items()),
            "update": dist["update_gap"], "update_worst": dist["update_worst_leaf"],
            "still": max((float(moved[k].abs().max()) for k in ref_moved if k not in kept), default=0.0)}


@pytest.mark.parametrize("side", ["program", "fp8_control"])
def test_steps_match_the_reference(run, side):
    """Each step's loss, the first gradient leaf by leaf (Adam's exp_avg /
    (1 - b1)) and the change after 3 steps within their tolerances; the
    reference computed in fp8 in the program's place fails one at least."""
    d, batches = run
    (first, _), (after, _) = d.first, d.after
    sd0 = d.sd0
    ref_losses, ref_grad, ref_leaves = ref.train_steps(sd0, batches, d.cfg["lr"], d.cfg["num_heads"])
    ref_moved = {k: ref_leaves[k] - sd0[k] for k in ref_grad}
    if side == "program":
        losses = [float(x) for x in d.losses]
        grad = {k: m / (1 - B1) for k, (_, m, _) in first.items()}
        moved = {k: after[k][0] - sd0[k] for k in grad}
    else:
        losses, grad, leaves = ref.train_steps(sd0, batches, d.cfg["lr"], d.cfg["num_heads"], "fp8")
        moved = {k: leaves[k] - sd0[k] for k in grad}
    assert set(grad) == set(ref_grad)
    gaps = _gaps(losses, grad, moved, ref_losses, ref_grad, ref_moved)
    within = {"loss": gaps["loss"] <= LOSS_TOL, "grad": gaps["grad"] <= GRAD_TOL,
              "update": gaps["update"] <= UPDATE_TOL, "update_worst": gaps["update_worst"] <= UPDATE_WORST_TOL,
              "still": gaps["still"] == 0}
    if side == "program":
        assert all(within.values()), gaps
    else:
        assert not all(within.values()), gaps


@pytest.mark.parametrize("side", ["program", "fp8_control"])
def test_window_step_forward_matches_the_reference(side):
    """The check's window step (here the first of the window): the pooled
    features, their deviations from the group's mean and the logits the
    program computed in that step, against the reference's f32 forward of
    the program's crops from the tensors the program held, each within
    FEAT_TOL; the reference computed in fp8 in the program's place fails
    each."""
    cfg, tr = _cut()
    d = driver.Driver(cfg, dict(tr, check_window_steps=1), SEED + 1, torch.device("cpu"))
    d.request()
    out = d.check(np.random.default_rng(0), side == "fp8_control")
    gaps = {k: out[k] for k in ("step_feat_gap", "step_feat_dev_gap", "step_logit_gap")}
    if side == "program":
        assert max(gaps.values()) <= FEAT_TOL, gaps
    else:
        assert min(gaps.values()) > FEAT_TOL, gaps


def _net_and_batch(kind, dtype):
    g = torch.Generator().manual_seed(3)
    if kind == "score":
        net = tnet.init_score_net(tnet.ScoreNetCfg(base_width=4), g)
        batch = {"A": torch.rand(5, 32, 32, 6, generator=g), "B": torch.rand(5, 32, 32, 6, generator=g),
                 "target": -torch.rand(5, generator=g) * 4}
    else:
        net = tnet.init_refine_net(tnet.RefineNetCfg(base_width=4), g)
        batch = {"A": torch.rand(2, 32, 32, 6, generator=g), "B": torch.rand(2, 32, 32, 6, generator=g),
                 "trans_target": torch.zeros(2, 3), "rot_target": torch.zeros(2, 3)}
    return net, training.make_optimizer(training.TrainCfg(compute_dtype=dtype), net, "cpu"), batch


@pytest.mark.parametrize("kind", ["score", "refine"])
def test_a_step_records_its_stages(kind):
    net, opt, batch = _net_and_batch(kind, "float32")
    cfg = training.TrainCfg(compute_dtype="float32")
    step = training.score_train_step if kind == "score" else training.refine_train_step
    profiling.reset()
    profiling.enable()
    try:
        step(net, opt, cfg, batch)
    finally:
        profiling.disable()
    (req,) = profiling.requests("train")
    (root,) = req.named("step")
    i = req.spans.index(root)
    assert [s.name for s in req.spans if s.parent == i] == STAGES[kind]
    assert all(s.duration > 0 for s in req.spans)
    profiling.reset()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_score_loss_is_the_forward_s(dtype):
    """score_loss_fn runs the net's parts in forward's order: the same bits."""
    net, _, batch = _net_and_batch("score", "float32")
    with torch.no_grad():
        logits = net(batch["A"], batch["B"], dtype=dtype)
        want = -(torch.softmax(batch["target"], -1) * torch.log_softmax(logits, -1)).sum()
        assert torch.equal(training.score_loss_fn(net, batch, dtype), want)


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys; import benchmark.reference.score_train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'foundationpose_torch', "
            "'foundationpose_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
