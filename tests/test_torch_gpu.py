"""Tests of the CUDA kernels on the card (torch only, no JAX).

They skip without a card. On the card run them with
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
(--noconftest: the suite's conftest configures JAX, which the machine
with the card does not have).
"""
import numpy as np
import pytest
import torch

from foundationpose_torch.ops import attention_cuda, epilogue_cuda, raster_cuda, segment_add_cuda
from foundationpose_torch.ops.attention import attention_core_plain
from foundationpose_torch.ops.rasterizer import render_mesh, render_mesh_brute

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-3), (torch.float32, 1e-4)])
@pytest.mark.parametrize(
    "B,L,D,H",
    [
        (2, 20, 256, 2), (1, 252, 512, 4), (4, 400, 512, 4),  # main-path widths
        (3, 9, 24, 3), (2, 77, 48, 2),  # dh = 8, 24: not multiples of 16
        (2, 1, 512, 4), (2, 513, 512, 4),  # L = 1; ragged L past 8 key tiles
        (2, 50, 20, 4), (1, 130, 200, 2),  # dh = 5, 100: element loads, padded head
    ],
)
def test_attention_kernel_matches_plain(card, dtype, tol, B, L, D, H):
    x = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (B, L, 3 * D)), dtype=torch.float32)
    x = x.to(card, dtype)
    before = attention_cuda.KERNEL.launches
    out = attention_cuda.attention_core_cuda(x, H)
    torch.cuda.synchronize()
    assert attention_cuda.KERNEL.launches == before + 1
    assert (out.float() - attention_core_plain(x, H).float()).abs().max().item() < tol


@pytest.mark.parametrize(
    "case", ["plain", "cull_texture_normal", "slivers"]
)
def test_raster_kernel_matches_brute(card, case):
    from chip_smoke import sliver_scene
    from foundationpose_torch.geometry.icosphere import icosphere
    from foundationpose_torch.geometry.rotations import so3_exp_map
    from foundationpose_torch.meshio import compute_vertex_normals

    rng = np.random.default_rng(0)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=card)  # noqa: E731
    if case == "slivers":  # slivers whose edge test accepts pixels far outside their bbox
        verts, faces = sliver_scene()
        P, K = np.eye(4, dtype=np.float32)[None], np.eye(3)
        kw = dict(out_hw=(160, 160), vnormals=T(np.tile([0.0, 0.0, -1.0], (len(verts), 1))),
                  use_light=True, vertex_color=T(rng.uniform(0, 1, (len(verts), 3))))
    else:
        verts, faces = icosphere(3, radius=0.1)
        P = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
        P[:, :3, :3] = so3_exp_map(torch.as_tensor(rng.normal(size=(6, 3)), dtype=torch.float32)).numpy()
        P[:, 2, 3] = rng.uniform(0.4, 1.2, 6)
        K = np.array([[500.0, 0, 100.0], [0, 500.0, 80.0], [0, 0, 1.0]])
        full = case == "cull_texture_normal"
        kw = dict(out_hw=(150, 200), vnormals=T(compute_vertex_normals(verts, faces)),
                  use_light=True, get_normal=full, cull_backfaces=full)
        if full:
            kw.update(uv=T(rng.uniform(0, 1, (len(verts), 2))), tex=T(rng.uniform(0, 1, (8, 8, 3))))
        else:
            kw["vertex_color"] = T(rng.uniform(0, 1, (len(verts), 3)))
    args = (T(verts), torch.as_tensor(faces, device=card), T(P), T(K))
    a = render_mesh(*args, **kw)
    b = render_mesh_brute(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.mask, b.mask) and a.mask.any()
    for f in ("color", "xyz") + (("normal",) if a.normal is not None else ()):
        assert (getattr(a, f) - getattr(b, f)).abs().max().item() < 2e-4, f


def test_raster_boxes_match_plain_and_shade_does_not_sync(card):
    """The face-box kernel is bit-equal to its plain version, and K1's
    wrapper synchronises nothing on mesh tensors from make_mesh_tensors."""
    from foundationpose_torch.geometry.icosphere import icosphere
    from foundationpose_torch.meshio import TriMesh
    from foundationpose_torch.ops.rasterizer import _prepare, shade_brute
    from foundationpose_torch.pipeline.mesh_tensors import make_mesh_tensors

    verts, faces = icosphere(3, radius=0.1)
    mt = make_mesh_tensors(TriMesh(vertices=verts, faces=faces), device=card)
    P = torch.eye(4, device=card).repeat(4, 1, 1)
    P[:, 2, 3] = torch.tensor([0.3, 0.5, 0.8, 3.0], device=card)
    K = torch.tensor([[500.0, 0, 60.0], [0, 500.0, 50.0], [0, 0, 1.0]], device=card)
    prep = _prepare(mt.pos, mt.faces, P, K, (100, 120), None, mt.vertex_color, None, mt.vnormals,
                    True, False, None, True)
    fk, ck = raster_cuda.kernel_boxes(prep)
    fp, cp = raster_cuda._records(prep)
    assert torch.equal(fk, fp) and torch.equal(ck, cp)
    torch.cuda.synchronize()
    before = raster_cuda.KERNEL.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = raster_cuda.raster_shade(prep, None, 0.8, 0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert raster_cuda.KERNEL.launches == before + 1
    color, xyz, _, mask = shade_brute(prep, None, 0.8, 0.5)
    assert torch.equal(out[3], mask) and mask.any()
    assert (out[0] - color).abs().max().item() < 2e-4 and (out[1] - xyz).abs().max().item() < 2e-4


def _first_conv_inputs(card, n, seed=5):
    """The trunks' first ConvBNReLU (6 -> 64, 7x7, stride 2; BN statistics
    away from the identity) and n pairs of 160x160 crops on the card, f32."""
    from foundationpose_torch.models import layers as L

    gen = torch.Generator().manual_seed(seed)
    layer = L.init_weights_(L.ConvBNReLU(6, 64, 7, 2, True), gen)
    bn = layer.net[1]
    with torch.no_grad():
        bn.running_mean.copy_(torch.rand(64, generator=gen) - 0.5)
        bn.running_var.copy_(torch.rand(64, generator=gen) + 0.2)
        bn.weight.copy_(torch.rand(64, generator=gen) + 0.5)
        bn.bias.copy_(torch.rand(64, generator=gen) - 0.5)
    A, B = (torch.rand((n, 160, 160, 6), generator=gen).to(card) * 2 - 1 for _ in range(2))
    return layer.eval().to(card), A, B


def test_padded_first_conv_matches_f32(card):
    """The first conv at the register's shape (252 pairs) in bf16, its
    input padded as models/networks.py::_tokens pads it and its epilogue
    fused: within twice its three bf16 roundings (product, bias, BN: each
    at most 2^-8 of the value rounded) and the f32 sums' order of an f32
    conv and epilogue of the same bf16 inputs and weight, and counted as
    one padded conv and one fused epilogue."""
    from foundationpose_torch.models import networks as nets
    from foundationpose_torch.utils import profiling

    layer, A, B = _first_conv_inputs(card, 252)
    bf = torch.bfloat16
    c_pad = nets.padded_channels(6, bf, card)
    assert c_pad % 8 == 0 and c_pad > 6
    x = nets.pad_pairs(A, B, bf, c_pad)
    profiling.reset()
    profiling.enable()
    try:
        with torch.inference_mode():
            got = layer(x.permute(0, 3, 1, 2), bf, pad_to=c_pad).float()
    finally:
        profiling.disable()
    counted = profiling.counters()
    profiling.reset()
    assert counted == {"conv.channel_pad": 1, "epilogue.fused": 1}
    conv, bn = layer.net[0], layer.net[1]
    with torch.inference_mode():
        x32, w32 = x[..., :6].float().permute(0, 3, 1, 2), conv.weight.to(bf).float()
        prod = torch.nn.functional.conv2d(x32, w32, None, 2, 3)
        biased = prod + conv.bias[:, None, None]
        scale = (bn.weight * torch.rsqrt(bn.running_var + 1e-5))[:, None, None]
        want = torch.relu((biased - bn.running_mean[:, None, None]) * scale + bn.bias[:, None, None])
        # f32 sums of 294 products in any order: within 294 x 2^-24 of the sum of their sizes
        acc = 294 * 2 ** -24 * torch.nn.functional.conv2d(x32.abs(), w32.abs(), None, 2, 3)
        tol = 2 * 2 ** -8 * (scale.abs() * (prod.abs() + biased.abs()) + want.abs()) + scale.abs() * acc
        assert got.shape == want.shape == (504, 64, 80, 80)
        assert ((got - want).abs() <= tol).all()
        assert (got > 0).float().mean() > 0.2


def test_first_conv_runs_no_generic_engine(card):
    """A profiled forward of a trunk's first stage (RefineNet's encodeA at
    base width 64) on padded input, as the trunk runs it
    (`networks._encode_pairs`), launches no kernel of cuDNN's generic
    engine (convolve_common_engine), which the same stage launches on the
    6 unpadded channels."""
    from torch.profiler import ProfilerActivity, profile

    from foundationpose_torch.models import networks as nets

    net = nets.init_refine_net(nets.RefineNetCfg(), torch.Generator().manual_seed(0)).to(card)
    _layer, A, B = _first_conv_inputs(card, 16)
    bf = torch.bfloat16
    unpadded = torch.cat([A, B]).to(bf).permute(0, 3, 1, 2)
    forwards = {"padded": lambda: nets._encode_pairs(net.encodeA, A, B, bf),
                "c6": lambda: nets._run(net.encodeA, unpadded, bf)}
    kernels = {}
    with torch.inference_mode():
        for name, fn in forwards.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels[name] = {e.key for e in prof.key_averages()}
    assert any("convolve_common_engine" in k for k in kernels["c6"])
    assert not any("convolve_common_engine" in k for k in kernels["padded"])
    assert any("fprop" in k for k in kernels["padded"])


def test_recorded_register_counts_padded_convs(card):
    """A register in bf16 with the network scorer, recorded: its 5 refiner
    forwards and 1 scorer forward each count one padded first conv, and
    every epilogue takes the fused kernel, as many as before the pad
    (25 a RefineNet forward, 20 a ScoreNet forward)."""
    import dataclasses

    from chip_smoke import K_SMALL, REGISTER_EPILOGUES, _estimator, _small_scene
    from foundationpose_torch.utils import profiling

    box, cfg, frame = _small_scene()
    cfg = dataclasses.replace(
        cfg, refiner=dataclasses.replace(cfg.refiner, compute_dtype="bfloat16"),
        scorer=dataclasses.replace(cfg.scorer, mode="network", compute_dtype="bfloat16"))
    est = _estimator(box, cfg, card, head_scale=0.05)
    profiling.reset()
    profiling.enable()
    try:
        est.register(K_SMALL, *frame, iteration=5)  # a key's first call runs its body eagerly
        torch.cuda.synchronize()
    finally:
        profiling.disable()
    counted = profiling.counters()
    profiling.reset()
    assert counted.get("conv.channel_pad") == 6
    assert counted.get("epilogue.fused") == REGISTER_EPILOGUES
    assert "epilogue.plain" not in counted


def test_launch_counters_count_launches(card):
    r0, a0 = raster_cuda.KERNEL.launches, attention_cuda.KERNEL.launches
    attention_cuda.attention_core_cuda(torch.zeros(1, 4, 24, device=card), 2)
    torch.cuda.synchronize()
    assert attention_cuda.KERNEL.launches == a0 + 1
    assert raster_cuda.KERNEL.launches == r0


def test_funneled_register_matches_cpu(card):
    """An f32 funneled register at test width (prune after 1 of 2
    iterations, keep 8): the whole order equal on the card and the CPU,
    poses within 1e-4, K1 launched 4 times (2 + 1 pre-score + 1)."""
    from chip_smoke import funnel_slice

    cpu = funnel_slice("cpu")
    r0 = raster_cuda.KERNEL.launches
    gpu = funnel_slice(card)
    assert raster_cuda.KERNEL.launches - r0 == 4
    np.testing.assert_array_equal(gpu[0], cpu[0])
    assert np.abs(gpu[1] - cpu[1]).max() < 1e-4 and np.abs(gpu[2] - cpu[2]).max() < 1e-4
    assert (cpu[3] > 1e4).sum() == 8


def test_track_chain_replays_per_frame_packed(card):
    """track_chain_graph on the card (one tracking step captured in a CUDA
    graph, replayed once per frame) against track_packed_body, the eager
    step, called per frame: bit-equal trajectories; K1 and K2 counted."""
    import dataclasses

    from chip_smoke import K_SMALL, _estimator, _frame, _small_scene
    from foundationpose_torch.pipeline import graph

    box, cfg, _frame0 = _small_scene()
    est = _estimator(box, dataclasses.replace(cfg, track_roi=False), card, head_scale=0.05)
    frames = [_frame(box, (0.01 + 0.002 * i, -0.02, 0.85), (120, 160), K_SMALL, "cpu") for i in range(5)]
    bufs = np.stack([graph.pack_track_frame(r, d, 0, 0) for r, d, _m in frames])
    pose0 = torch.eye(4, device=card)
    pose0[:3, 3] = torch.tensor([0.012, -0.018, 0.86])
    K = torch.as_tensor(K_SMALL, device=card)
    args = (est.refiner, est.cfg, est.mesh_tensors)
    seq, p = [], pose0
    with torch.inference_mode():
        for b in bufs:
            p = graph.track_packed_body(*args, p, K, torch.as_tensor(b, device=card), est._diam,
                                        (120, 160), 2)
            seq.append(p)
    r0, a0 = raster_cuda.KERNEL.launches, attention_cuda.KERNEL.launches
    chain = graph.track_chain_graph(*args, pose0, K, bufs, est._diam, (120, 160), 2)
    torch.cuda.synchronize()
    assert raster_cuda.KERNEL.launches > r0 and attention_cuda.KERNEL.launches > a0
    assert torch.equal(chain, torch.stack(seq))
    assert (chain[-1] - chain[0]).abs().max().item() > 1e-4


def test_captured_steps_match_eager_bodies_and_count_replays(card):
    """Every captured tracking step (pipeline/step_graphs.py) bit-equal to
    its eager body on the card, on two frames (the capture, then a replay
    on new inputs); a replay adds the K1 / K2 / epilogue launches its
    capture recorded (2, 4 and 50 a tracked frame of 2 iterations, 25
    epilogues a RefineNet forward; 2M, 4 and 50 for M objects)."""
    from chip_smoke import K_SMALL, _estimator, _frame, _small_scene, captured_against_eager
    from foundationpose_torch.pipeline import MultiTracker

    box, cfg, _frame0 = _small_scene()
    est = _estimator(box, cfg, card, head_scale=0.05)
    est.pose_last = torch.eye(4, device=card)
    est.pose_last[:3, 3] = torch.tensor([0.012, -0.018, 0.86])
    multi = MultiTracker(meshes=[box, box], cfg=cfg, refiner_params=est.refiner, device=card)
    poses = np.tile(np.eye(4), (2, 1, 1))
    poses[:, :3, 3] = [[-0.05, 0.0, 0.9], [0.06, -0.01, 0.95]]
    multi.set_poses(poses)
    frames = [_frame(box, (0.01 + 0.003 * i, -0.02, 0.85), (120, 160), K_SMALL, "cpu")
              for i in range(2)]
    paths = captured_against_eager(est, multi, frames, K_SMALL, (64, 96))
    assert len(paths) == 8
    for name, (got, want, graphs) in paths.items():
        assert torch.equal(got, want), name
        assert len(graphs) == 1, name
    kernels = (raster_cuda.KERNEL, attention_cuda.KERNEL, epilogue_cuda.KERNEL)
    for name, per_replay in (("track_packed (full frame)", (2, 4, 50)),
                             ("multi_packed (full frame)", (4, 4, 50))):
        (_key, step), = paths[name][2].items()
        assert dict(step.launches) == dict(zip(kernels, per_replay))
        before = [k.launches for k in kernels]
        step(*[x.clone() for x in step.inputs])
        torch.cuda.synchronize()
        assert tuple(k.launches - n for k, n in zip(kernels, before)) == per_replay


def _row_bound(abs_sum):
    """Atomic sums run in another order each launch: per-row bound."""
    return 1e-5 * abs_sum + 1e-30


def _corner_stream(card):
    """The (idx, upd) pair the "cuda"-layout hash-grid backward sends K3,
    in its order: 64 rays x 256 samples through the unit cube, stratified
    along each ray, at HashGridCfg's defaults (2M updates, 36M rows)."""
    from foundationpose_torch.ops import hashgrid

    g = torch.Generator(device=card).manual_seed(3)
    o = torch.nn.functional.normalize(torch.randn((64, 3), generator=g, device=card), dim=1) * 1.4
    d = torch.nn.functional.normalize(torch.rand((64, 3), generator=g, device=card) * 0.6 - 0.3 - o, dim=1)
    t = torch.linspace(0.2, 2.6, 256, device=card) + torch.rand((64, 256), generator=g, device=card) * 0.01
    x = (o[:, None] + d[:, None] * t[..., None]).reshape(-1, 3)
    cfg = hashgrid.HashGridCfg()
    T = cfg.level_tables()[3]
    emb = torch.zeros((T, 2), device=card, requires_grad=True)
    grabbed = []
    orig = hashgrid.segment_add_planes
    hashgrid.segment_add_planes = lambda *a: grabbed.append(a) or orig(*a)
    try:
        hashgrid.hashgrid_encode(emb, x, cfg).backward(torch.randn((len(x), 32), generator=g, device=card))
    finally:
        hashgrid.segment_add_planes = orig
    (idx, upd, _T), = grabbed
    return idx, upd, T


def _random_stream(card):
    g = torch.Generator(device=card).manual_seed(0)
    M, T, C = 1 << 20, 50_000, 2
    idx = torch.randint(0, T, (M,), generator=g, device=card, dtype=torch.int32)
    idx[: M // 10] = 17  # heavy duplication
    idx[M // 10 : M // 10 + M // 100] = T  # the drop sentinel
    return idx, torch.randn((C, M), generator=g, device=card), T


def _second_order_stream(card, layout):
    """The (idx, upd) pair an eikonal loss's second-order table term sends
    K3: the hash grid's points' gradient, differentiable again, of a
    piecewise-linear head, then a loss on its norm; 32 rays x 128 samples
    at HashGridCfg's defaults in `layout` (eight corner rows a point and
    level in both layouts)."""
    from foundationpose_torch.ops import hashgrid

    g = torch.Generator(device=card).manual_seed(4)
    o = torch.nn.functional.normalize(torch.randn((32, 3), generator=g, device=card), dim=1) * 1.4
    d = torch.nn.functional.normalize(torch.rand((32, 3), generator=g, device=card) * 0.6 - 0.3 - o, dim=1)
    t = torch.linspace(0.2, 2.6, 128, device=card) + torch.rand((32, 128), generator=g, device=card) * 0.01
    x = (o[:, None] + d[:, None] * t[..., None]).reshape(-1, 3).requires_grad_()
    cfg = hashgrid.HashGridCfg(layout=layout)
    T = cfg.level_tables()[3]
    emb = (torch.rand((T, 2), generator=g, device=card) - 0.5).requires_grad_()
    head = torch.randn((cfg.out_dim,), generator=g, device=card)
    grabbed = []
    orig = hashgrid.corner_table_grad
    hashgrid.corner_table_grad = lambda *a: grabbed.append(a) or orig(*a)
    try:
        sdf = torch.relu(hashgrid.hashgrid_encode(emb, x, cfg, table_grad=False) @ head).sum()
        n, = torch.autograd.grad(sdf, x, create_graph=True)
        ((torch.linalg.vector_norm(n, dim=-1) - 1) ** 2).sum().backward()
    finally:
        hashgrid.corner_table_grad = orig
    (idx, upd, _T), = grabbed
    assert upd.shape == (2, 32 * 128 * cfg.n_levels * 8)
    return idx, upd, T


@pytest.mark.parametrize("stream", [
    _random_stream, _corner_stream,
    lambda card: _second_order_stream(card, "oct"), lambda card: _second_order_stream(card, "cuda"),
], ids=["random", "corners", "second_order_oct", "second_order_cuda"])
def test_k3_matches_plain(card, stream):
    from foundationpose_torch.ops.segment_add import segment_add_planes_plain

    idx, upd, T = stream(card)
    before = segment_add_cuda.K3.launches
    out = segment_add_cuda.segment_add_planes_cuda(idx, upd, T)
    torch.cuda.synchronize()
    assert segment_add_cuda.K3.launches == before + 1
    want = segment_add_planes_plain(idx, upd, T)
    bound = _row_bound(segment_add_planes_plain(idx, upd.abs(), T))
    assert ((out - want).abs() <= bound).all() and want.abs().sum() > 0


@pytest.mark.parametrize("C,M", [(1, 9_999), (3, 10_001), (8, 4_097), (32, 1_000)])
def test_k3_other_widths_match_plain(card, C, M):
    """Channel counts other than the backward's 2 (scalar and v4
    reductions, several passes), M not a multiple of 4 (scalar loads),
    negative and too large indices."""
    from foundationpose_torch.ops.segment_add import segment_add_planes_plain

    g = torch.Generator(device=card).manual_seed(C)
    T = 3000
    idx = torch.randint(-5, T + 5, (M,), generator=g, device=card, dtype=torch.int32)
    idx[M // 3 : M // 2] = 11
    upd = torch.randn((C, M), generator=g, device=card)
    out = segment_add_cuda.segment_add_planes_cuda(idx, upd, T)
    want = segment_add_planes_plain(idx, upd, T)
    assert ((out - want).abs() <= _row_bound(segment_add_planes_plain(idx, upd.abs(), T))).all()


def test_k4_matches_plain(card):
    """The folded K4 against its plain version (the (T, 8C) base-row sums
    rolled back per level) on the "oct" levels of a small grid: dense and
    hashed levels, shifts that wrap past a level's end, runs of one base
    row, 1% out-of-bounds entries (level start, zero cotangent) and
    indices outside [0, T) or outside their level, which both drop."""
    from foundationpose_torch.ops.hashgrid import HashGridCfg, oct_levels
    from foundationpose_torch.ops.segment_add import factored_segment_add_plain

    g = torch.Generator(device=card).manual_seed(1)
    cfg = HashGridCfg(n_levels=6, base_resolution=16, desired_resolution=256, log2_hashmap_size=16, layout="oct")
    levels = oct_levels(cfg)
    offs, sizes = (torch.as_tensor(a, device=card) for a in levels[:2])
    res = cfg.level_tables()[0]
    assert ((res + 1) ** 3 <= levels[1]).any() and ((res + 1) ** 3 > levels[1]).any()
    L, N, C = len(sizes), 1 << 17, 2
    T = int(offs[-1] + sizes[-1])
    base = (torch.rand((N, L), generator=g, device=card) * sizes).long()
    base[: N // 2] = base[: N // 2 : 8].repeat_interleave(8, dim=0)  # runs of 8 points on one row
    base[-N // 8 :] = sizes - 1 - base[-N // 8 :] % 64  # near each level's end: corners wrap
    idx = offs + base
    w = [torch.rand((N, L), generator=g, device=card) for _ in range(8)]
    gp = torch.randn((N, L, C), generator=g, device=card)
    zero = torch.rand((N, L), generator=g, device=card) < 0.01  # oob entries: level start, zero g
    idx = torch.where(zero, offs, idx)
    gp = torch.where(zero[..., None], 0.0, gp)
    idx[:50, 0] = -3
    idx[50:100, L - 1] = T + 5
    idx[100:150, 1] = offs[2]  # inside [0, T), outside its level
    idx = idx.int()
    before = segment_add_cuda.K4.launches
    out = segment_add_cuda.factored_segment_add_cuda(idx, w, gp, levels)
    torch.cuda.synchronize()
    assert segment_add_cuda.K4.launches == before + 1
    assert out.shape == (T, C)
    want = factored_segment_add_plain(idx, w, gp, levels)
    bound = _row_bound(factored_segment_add_plain(idx, w, gp.abs(), levels))
    assert ((out - want).abs() <= bound).all() and want.abs().sum() > 0


def test_oct_table_grad_folds_in_k4(card):
    """The "oct" encoder's table gradient on the card against the same
    backward on the CPU (plain K4 and its roll fold), per-row bound; on the
    card the backward allocates less than one (T, 8C) f32 block at its
    peak and launches K4 once."""
    from foundationpose_torch.ops.hashgrid import HashGridCfg, hashgrid_encode

    cfg = HashGridCfg(n_levels=8, base_resolution=16, desired_resolution=512, log2_hashmap_size=19, layout="oct")
    T, C = cfg.level_tables()[3], cfg.level_dim
    gen = torch.Generator().manual_seed(6)
    o = torch.nn.functional.normalize(torch.randn((128, 3), generator=gen), dim=1) * 1.4
    d = torch.nn.functional.normalize(torch.rand((128, 3), generator=gen) * 0.6 - 0.3 - o, dim=1)
    t = torch.linspace(0.2, 2.6, 256) + torch.rand((128, 256), generator=gen) * 0.01
    x = (o[:, None] + d[:, None] * t[..., None]).reshape(-1, 3)  # rays of samples, some out of bounds
    emb = torch.rand((T, C), generator=gen) - 0.5
    cot = torch.randn((len(x), cfg.out_dim), generator=gen)

    def cpu_grad(c):
        e = emb.clone().requires_grad_()
        hashgrid_encode(e, x, cfg).backward(c)
        return e.grad

    want, bound = cpu_grad(cot), _row_bound(cpu_grad(cot.abs()))  # weights are >= 0
    e = emb.to(card).requires_grad_()
    out = hashgrid_encode(e, x.to(card), cfg)
    cot_card = cot.to(card)
    torch.cuda.synchronize()
    before, held = segment_add_cuda.K4.launches, torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    out.backward(cot_card)
    torch.cuda.synchronize()
    assert segment_add_cuda.K4.launches == before + 1
    assert torch.cuda.max_memory_allocated(card) - held < T * 8 * C * 4
    assert ((e.grad.cpu() - want).abs() <= bound).all() and want.abs().sum() > 0


def test_hashgrid_backward_launches_k3_k4(card):
    from foundationpose_torch.ops.hashgrid import HashGridCfg, hashgrid_encode

    x = torch.rand((4096, 3), generator=torch.Generator(device=card).manual_seed(2), device=card) * 2 - 1
    for layout, counter in (("cuda", segment_add_cuda.K3), ("oct", segment_add_cuda.K4)):
        cfg = HashGridCfg(n_levels=6, log2_hashmap_size=14, layout=layout)
        emb = torch.zeros((cfg.level_tables()[3], 2), device=card, requires_grad=True)
        before = counter.launches
        hashgrid_encode(emb, x, cfg).sum().backward()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert torch.isfinite(emb.grad).all() and emb.grad.abs().sum() > 0


@pytest.mark.parametrize("uploads", ["unpacked", "packed"])
def test_register_step_captured_at_the_second_call(card, uploads):
    """An estimator's register step on the card (test width, f32): the
    first register runs the step's body eagerly (no graph), the second
    captures it, the third replays it; each is bit-equal to the eager
    body (a register through an empty cache of steps, where its key's
    first call runs eagerly), and each counts the eager body's K1 and K2
    launches (the capture counts nothing, its replay adds what the
    capture recorded)."""
    import dataclasses

    from chip_smoke import K_SMALL, _estimator, _small_scene
    from foundationpose_torch.pipeline.step_graphs import StepGraphs

    box, cfg, frame = _small_scene()
    if uploads == "packed":
        cfg = dataclasses.replace(cfg, register_pack=True)
    est = _estimator(box, cfg, card, head_scale=0.05)

    def counted(register):
        r0, a0 = raster_cuda.KERNEL.launches, attention_cuda.KERNEL.launches
        register(K_SMALL, *frame, iteration=2)
        torch.cuda.synchronize()
        return raster_cuda.KERNEL.launches - r0, attention_cuda.KERNEL.launches - a0

    graphs, est._graphs = est._graphs, StepGraphs()
    eager = counted(est.register)
    est._graphs = graphs
    want = (est.order.clone(), est.poses.clone(), est.scores.clone())
    assert len(est._graphs) == 0 and eager[0] > 0 and eager[1] > 0
    for call in range(3):
        assert counted(est.register) == eager
        (_key, step), = est._graphs.items()
        assert (step.graph is None) == (call == 0)
        assert (step.eager_runs, step.replays) == (1, call)
        assert all(torch.equal(a, b) for a, b in zip((est.order, est.poses, est.scores), want))


def test_replayed_steps_read_their_device_stages(card):
    """The recorder (utils/profiling.py) on a replayed register and tracked
    frames (f32): each stage, read from the timing-event nodes
    the capture recorded, is positive and in the body's order, and a
    register's stages add up to within 10% of the median of three
    event-timed replays of its step (each launched while the device
    sleeps, so the events time the graph and not its launch); a frame whose
    graph was replayed again before its fetch drops its read and counts
    it; the capture counters count the capture and survive clear()."""
    import dataclasses

    from chip_smoke import K_SMALL, _estimator, _small_scene
    from foundationpose_torch.models import RefineNetCfg, ScoreNetCfg
    from foundationpose_torch.utils import profiling

    box, cfg, frame = _small_scene()
    # nets of width 32 on 96 px crops: at test width the graph's fixed cost of a launch on
    # the device (~0.5 ms) would be a seventh of the replay
    cfg = dataclasses.replace(
        cfg, register_pack=True,
        refiner=dataclasses.replace(cfg.refiner, net=RefineNetCfg(base_width=32), input_res=96),
        scorer=dataclasses.replace(cfg.scorer, net=ScoreNetCfg(base_width=32), input_res=96))
    est = _estimator(box, cfg, card, head_scale=0.05)
    for _ in range(2):  # eager, then captured
        est.register(K_SMALL, *frame, iteration=2)
    assert est._graphs.captures == 1 and est._graphs.capture_s > 0
    profiling.reset()
    profiling.enable()
    try:
        est.register(K_SMALL, *frame, iteration=2)
        for _ in range(2):  # the first frame captures its step, the second replays it
            est.track_one(frame[0], frame[1], K_SMALL, iteration=2)
        in_flight = [est.track_one_async(frame[0], frame[1], K_SMALL, iteration=2) for _ in range(2)]
        for r in in_flight:
            r.result()
    finally:
        profiling.disable()

    def stages(req):
        (root,) = req.named("step")
        return [s for s in req.spans if s.parent == req.spans.index(root)]

    (reg,) = profiling.requests("register")
    got = stages(reg)
    per_iter = ["crops", "refiner", "update"] * 2
    assert [s.name for s in got] == ["prep"] + per_iter + ["score.crops", "score.net", "rank"]
    assert all(s.duration > 0 for s in got)
    step = next(s for (path, *_), s in est._graphs.items() if path[0] == "register_packed")
    replays = []
    for _ in range(3):  # the same step replayed between events, its launch hidden by a sleep
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        a.record()
        step.graph.replay()
        b.record()
        torch.cuda.synchronize()
        replays.append(a.elapsed_time(b) * 1e-3)
    assert sum(s.duration for s in got) == pytest.approx(sorted(replays)[1], rel=0.1)
    frames = profiling.requests("track")
    assert len(frames) == 4
    for req in frames[:2] + frames[3:]:
        assert [s.name for s in stages(req)] == ["prep"] + per_iter
        assert all(s.duration > 0 for s in stages(req))
    assert not frames[2].has_device_spans()
    # besides the captures' epilogue paths (models/layers.py::epilogue)
    assert {k: v for k, v in profiling.counters().items() if not k.startswith("epilogue.")} == {
        "device_reads_dropped": 1}
    captures = est._graphs.captures
    assert captures == 2
    est._graphs.clear()
    assert est._graphs.captures == captures
    profiling.reset()
