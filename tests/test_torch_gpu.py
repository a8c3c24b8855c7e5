"""Tests of the CUDA kernels on the card (torch only, no JAX).

They skip without a card. On the card run them with
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
(--noconftest: the suite's conftest configures JAX, which the machine
with the card does not have).
"""
import numpy as np
import pytest
import torch

from foundationpose_torch.ops import attention_cuda, raster_cuda, segment_add_cuda
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


@pytest.mark.parametrize("stream", [_random_stream, _corner_stream], ids=["random", "corners"])
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
    from foundationpose_torch.ops.segment_add import factored_segment_add_plain

    g = torch.Generator(device=card).manual_seed(1)
    L, N, NW, C = 4, 1 << 17, 8, 2
    sizes = torch.tensor([3000, 20_000, 50_000, 50_000], device=card)
    offs = torch.cumsum(sizes, 0) - sizes
    T = int(sizes.sum())
    idx = (offs[:, None] + (torch.rand((L, N), generator=g, device=card) * sizes[:, None]).long()).int()
    w = torch.rand((NW, L, N), generator=g, device=card)
    gp = torch.randn((C, L, N), generator=g, device=card)
    zero = torch.rand((L, N), generator=g, device=card) < 0.01  # oob entries: level start, zero g
    idx = torch.where(zero, offs[:, None].int(), idx)
    gp = torch.where(zero, 0.0, gp)
    before = segment_add_cuda.K4.launches
    out = segment_add_cuda.factored_segment_add_cuda(idx, w, gp, T)
    torch.cuda.synchronize()
    assert segment_add_cuda.K4.launches == before + 1
    want = factored_segment_add_plain(idx, w, gp, T)
    bound = _row_bound(factored_segment_add_plain(idx, w, gp.abs(), T))
    assert ((out - want).abs() <= bound).all()


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
