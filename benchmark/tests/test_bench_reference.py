"""The plain reference against the port's CPU path at test width: the
renderer, the depth filter, the crop windows, the nets, a register, a
tracked frame and three training steps. The port runs its plain versions
on the CPU (the brute rasterizer, the plain attention core), in f32, so
the two agree to rounding. The test imports both; the reference never
imports the port."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import conftest
from benchmark import harness, traffic, weights
from benchmark.reference import geometry as G
from benchmark.reference import nets
from benchmark.reference.pipeline import Crops, Mesh, crop_tf, filter_depth, train_steps
from benchmark.reference.render import render

SEED = 2**32 + 17


def _scene():
    cell, cfg, tr = conftest.small("register-bop")
    v, f, c = traffic.bench_mesh(cfg, SEED)
    mesh = Mesh.from_arrays(v, f, c, "cpu")
    K = traffic.intrinsics(cfg)
    hw = (cfg["frame_height"], cfg["frame_width"])
    return cfg, tr, mesh, K, hw


def test_renderer_against_the_ports_brute_path():
    from foundationpose_torch.ops.rasterizer import render_mesh_brute

    cfg, tr, mesh, K, hw = _scene()
    grid, _ = G.rotation_grid(40, 60, 30.0, 4)
    poses = torch.as_tensor(grid[::25], dtype=torch.float32)
    poses[:, :3, 3] = torch.tensor([0.01, -0.02, 0.8])
    Kt = torch.as_tensor(K)
    tf = crop_tf(poses, Kt, 1.2, 32, mesh.diameter)
    col, xyz, mask = render(mesh.pos, mesh.faces, mesh.color, mesh.normals, poses, Kt, (32, 32), tf, cull=True)
    out = render_mesh_brute(mesh.pos, mesh.faces, poses, Kt, out_hw=(32, 32), crop_tf=tf,
                            vertex_color=mesh.color, vnormals=mesh.normals, cull_backfaces=True)
    both = mask & out.mask
    assert (mask != out.mask).sum() <= 0.002 * out.mask.sum()
    assert (col - out.color)[both].abs().max() < 1e-4 and (xyz - out.xyz)[both].abs().max() < 1e-5


def test_depth_filter_and_crop_windows():
    from foundationpose_torch.geometry.projection import compute_crop_window_tf
    from foundationpose_torch.ops.depth_filters import bilateral_filter_depth, erode_depth

    cfg, tr, mesh, K, hw = _scene()
    frame = traffic.render_frames(mesh, traffic.register_poses(tr, K, hw, SEED), K, hw, "cpu")[0]
    d = torch.as_tensor(frame[1])
    assert torch.equal(filter_depth(d), bilateral_filter_depth(erode_depth(d, radius=2), radius=2))
    poses = torch.as_tensor(traffic.register_poses(tr, K, hw, SEED), dtype=torch.float32)
    Kt = torch.as_tensor(K)
    assert torch.allclose(crop_tf(poses, Kt, 1.2, 160, mesh.diameter),
                          compute_crop_window_tf(poses, Kt, 1.2, 160, mesh.diameter), rtol=1e-6)


def test_nets_against_the_ports_f32_nets():
    from foundationpose_torch.models.networks import RefineNet, RefineNetCfg, ScoreNetCfg, ScoreNetMultiPair

    cfg = dict(conftest.small("register-bop")[1], head_scale=1.0)
    gen = torch.Generator().manual_seed(SEED)
    sd_r, sd_s = weights.refiner_state(cfg, gen, "cpu"), weights.scorer_state(cfg, gen, "cpu")
    sd_s = weights.spread_scorer(sd_s, torch.rand(64, generator=gen), cfg["score_attention_scale"])
    ref, sco = RefineNet(RefineNetCfg(base_width=8)), ScoreNetMultiPair(ScoreNetCfg(base_width=8))
    ref.load_state_dict(sd_r)
    sco.load_state_dict(sd_s)
    A, B = torch.rand((2, 5, 32, 32, 6), generator=gen)
    with torch.no_grad():
        out = ref(A, B, dtype=torch.float32)
        t, r = nets.refine_net(sd_r, A, B, 4)
        assert torch.allclose(out["trans"], t, atol=1e-5) and torch.allclose(out["rot"], r, atol=1e-5)
        logits = nets.score_logits(sd_s, nets.score_pooled(sd_s, A, B, 4), 4)
        assert (sco(A, B, dtype=torch.float32) - logits).abs().max() < 1e-5 * logits.abs().max()


@pytest.mark.parametrize("workload", ["register-bop", "track-video"])
def test_register_and_track_against_the_ports_f32_path(workload):
    cell, cfg, tr = conftest.small(workload)
    cfg = dict(cfg, compute_dtype="float32")
    d = harness.make_driver(cfg, tr, SEED, "cpu")
    harness.run_window(d, 0, 2)
    n = d.check(np.random.default_rng(1))
    # A crop box rounded to the other whole pixel (the window's shifted
    # principal point rounds differently) moves one hypothesis's delta by a
    # few percent: up to ~0.03 mm of the ~6 mm these nets move a pose.
    key = "trans_gap_mm" if workload == "register-bop" else "track_trans_gap_mm"
    assert n[key] < 0.05 and n[key.replace("trans_gap_mm", "rot_gap_deg")] < 0.01
    assert n.get("logit_gap", n.get("start_logit_gap")) < 1e-3 and n.get("pick_gap", n.get("start_pick_gap")) < 1e-3
    if workload == "track-video":  # the frames, and the reference's own chain from its own register
        assert n["track_add_mm"] < 0.05 and n["chain_add_mm"] < 0.05


def test_training_against_the_ports_f32_steps():
    from foundationpose_torch.datasets import make_refiner_batch
    from foundationpose_torch.models import training
    from foundationpose_torch.models.networks import RefineNet, RefineNetCfg
    from foundationpose_torch.pipeline import RasterCfg, RefinerCfg, make_mesh_tensors
    from foundationpose_torch.meshio import TriMesh

    cfg = conftest.small("train-refiner")[1]
    v, f, c = traffic.bench_mesh(cfg, SEED)
    mesh = Mesh.from_arrays(v, f, c, "cpu")
    K = torch.as_tensor(traffic.intrinsics(cfg))
    sd = weights.refiner_state(cfg, torch.Generator().manual_seed(SEED), "cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    draws = [traffic.train_draws(gen, 4) for _ in range(3)]
    losses, first, leaves = train_steps(sd, mesh, K, draws, Crops(res=32), 1e-4, 4)

    net = RefineNet(RefineNetCfg(base_width=8))
    net.load_state_dict(sd)
    tcfg = training.TrainCfg(compute_dtype="float32")
    opt = training.make_optimizer(tcfg, net, "cpu")
    mt = make_mesh_tensors(TriMesh(vertices=mesh.pos.double().numpy(), faces=f, vertex_colors=c), device="cpu")
    rcfg = RefinerCfg(net=RefineNetCfg(base_width=8), input_res=32, raster=RasterCfg(cull_backfaces=True))
    diam = torch.tensor(mesh.diameter, dtype=torch.float32)
    for k, dr in enumerate(draws):
        batch = make_refiner_batch(None, mt, K, rcfg, diam, n=4, draws={"pairs": dr})
        loss = float(training.refine_train_step(net, opt, tcfg, batch))
        assert loss == pytest.approx(losses[k], rel=1e-4)
    after = net.state_dict()
    for k, x in leaves.items():
        assert (after[k] - x).abs().max() <= 3.1e-4, k  # entries resolved only to rounding flip under Adam
