"""The neural object field's train step against the benchmark's plain f32
reference (benchmark/reference/nerf.py) on the CPU, at a small cut of the
cell nerf-oct-train (4 levels, 2^12 rows a level, 3 views of 48x64, 64 rays
x (16 + 16) samples): the runner built as the cell builds it, 3 steps of
`loss_and_grads` and `apply_gradients` from the same seeded parameters and
the draws `step_draws` gives. In f32 the two differ only where the "oct"
layout rounds: its table read and the trilinear weights of its table
gradient are bf16 whatever `amp` says, which reaches the table's and the
first layer's gradients; with `amp` on they agree within the cell's
limits. Also: a step is one recorder request of kind "nerf" holding its
six device stages and the host span nerf.step, and `step` takes the draws
`step_draws` gives again."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import nerf as driver
from benchmark.drivers.train import B1
from benchmark.reference import nerf as ref
from foundationpose_torch import nerf
from foundationpose_torch.utils import profiling

SEED = 2**31 + 7
CUT = dict(num_levels=4, log2_hashmap_size=12, base_res=8, finest_res=32, frame_height=48, frame_width=64,
           fx=120.0, fy=120.0, views=3, first_frame_dilate=10, n_rand=64, n_samples=16, n_samples_around_depth=16)
# Leaves the table's bf16 read reaches, and their gradients' relative L2 gap in f32.
TABLE_LEAVES = ("grid", "mlp.sigma.0.weight")
TABLE_GAP, F32_GAP, F32_LOSS = 3e-3, 1e-5, 1e-4
STAGES = ("nerf.sample", "nerf.encode", "nerf.mlp", "nerf.backward", "nerf.grid_backward", "nerf.adam")


def _cell(amp: bool):
    cell = harness.find_cell(harness.manifest(), "nerf-oct-train")
    cfg, tr = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    cfg = dict(cfg, **CUT, amp=amp, mesh=dict(cfg["mesh"], subdivisions=2))
    return cfg, dict(tr, azimuth_step_deg=120, elevations_deg=[30])


def _runner(cfg, tr):
    views = driver.render_views(cfg, tr, SEED, torch.device("cpu"))
    return nerf.make_runner(driver.nerf_cfg(cfg), *views, seed=SEED, device="cpu")


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_steps_match_the_reference(amp):
    cfg, tr = _cell(amp)
    r = _runner(cfg, tr)
    p0 = {n: p.detach().clone() for n, p in r.model.named_parameters()}
    data = {k: r.rays[k] for k in ("dir", "rgb", "depth", "frame_id")}
    data |= {"occ": r.occ, "c2w": r.c2w, "sc_factor": r.cfg.sc_factor}
    draws = [r.step_draws(SEED, it)[:3] for it in range(3)]
    losses = []
    for it, d in enumerate(draws):
        loss, _, grads = r.loss_and_grads(*d)
        if it == 0:
            first = grads
        r.apply_gradients(grads)
        r.global_step += 1
        if it == 0:
            mu1 = {n: m.clone() for n, m in r.opt["mu"].items()}
        losses.append(float(loss))
    _, ref_first = ref.loss_and_grads(p0, data, draws[0], cfg)
    ref_losses, ref_clipped, ref_params = ref.train_steps(p0, data, draws, cfg)
    moved = {n: p.detach() - p0[n] for n, p in r.model.named_parameters()}
    gaps = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))}
    gaps |= driver.step_dists({n: m / (1 - B1) for n, m in mu1.items()}, ref_clipped, moved,
                              {n: ref_params[n] - p0[n] for n in p0})
    for name, limit in tr["limits"].items():
        if name in gaps:
            assert gaps[name] <= limit, (name, gaps[name])
    if not amp:
        assert gaps["loss_gap"] <= F32_LOSS
        for n in p0:
            assert _rel(first[n], ref_first[n]) <= (TABLE_GAP if n in TABLE_LEAVES else F32_GAP), n


def test_a_step_is_one_recorded_request():
    cfg, tr = _cell(True)
    r = _runner(cfg, tr)
    profiling.reset()
    profiling.enable()
    try:
        r.step(SEED)
    finally:
        profiling.disable()
    (req,) = profiling.requests("nerf")
    names = [s.name for s in req.spans]
    assert names[0] == "nerf.step" and set(STAGES) <= set(names) and "step" in names
    assert profiling.counters() == {"nerf.points": cfg["n_rand"] * (cfg["n_samples"] + cfg["n_samples_around_depth"])}
    device = req.seconds(*STAGES)
    assert 0 < device <= req.seconds("step") * (1 + 1e-9) and req.seconds("step") <= req.seconds("nerf.step")
    profiling.reset()


def test_step_takes_the_draws_step_draws_gives():
    cfg, tr = _cell(True)
    a, b = _runner(cfg, tr), _runner(cfg, tr)
    for _ in range(2):
        draws = b.step_draws(SEED, b.global_step)
        loss_b, _, grads = b.loss_and_grads(*draws)
        b.apply_gradients(grads)
        b.global_step += 1
        assert torch.equal(a.step(SEED)[0], loss_b)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert np.isfinite(float(loss_b))
