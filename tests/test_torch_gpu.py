"""Tests of the CUDA kernels on the card (torch only, no JAX).

They skip without a card. On the card run them with
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
(--noconftest: the suite's conftest configures JAX, which the machine
with the card does not have).
"""
import numpy as np
import pytest
import torch

from foundationpose_torch.ops import attention_cuda, raster_cuda
from foundationpose_torch.ops.attention import attention_core_plain
from foundationpose_torch.ops.rasterizer import render_mesh, render_mesh_brute

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-3), (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,L,D,H", [(2, 20, 256, 2), (1, 252, 512, 4), (4, 400, 512, 4), (3, 9, 24, 3)])
def test_attention_kernel_matches_plain(card, dtype, tol, B, L, D, H):
    x = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (B, L, 3 * D)), dtype=torch.float32)
    x = x.to(card, dtype)
    before = attention_cuda.KERNEL.launches
    out = attention_cuda.attention_core_cuda(x, H)
    torch.cuda.synchronize()
    assert attention_cuda.KERNEL.launches == before + 1
    assert (out.float() - attention_core_plain(x, H).float()).abs().max().item() < tol


@pytest.mark.parametrize("cull,texture,normal", [(False, False, False), (True, True, True)])
def test_raster_kernel_matches_brute(card, cull, texture, normal):
    from foundationpose_torch.geometry.icosphere import icosphere
    from foundationpose_torch.geometry.rotations import so3_exp_map
    from foundationpose_tpu.meshio import compute_vertex_normals

    verts, faces = icosphere(3, radius=0.1)
    rng = np.random.default_rng(0)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=card)  # noqa: E731
    P = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    P[:, :3, :3] = so3_exp_map(torch.as_tensor(rng.normal(size=(6, 3)), dtype=torch.float32)).numpy()
    P[:, 2, 3] = rng.uniform(0.4, 1.2, 6)
    K = np.array([[500.0, 0, 100.0], [0, 500.0, 80.0], [0, 0, 1.0]])
    kw = dict(out_hw=(150, 200), vnormals=T(compute_vertex_normals(verts, faces)),
              use_light=True, get_normal=normal, cull_backfaces=cull)
    if texture:
        kw.update(uv=T(rng.uniform(0, 1, (len(verts), 2))), tex=T(rng.uniform(0, 1, (8, 8, 3))))
    else:
        kw["vertex_color"] = T(rng.uniform(0, 1, (len(verts), 3)))
    args = (T(verts), torch.as_tensor(faces, device=card), T(P), T(K))
    a = render_mesh(*args, **kw)
    b = render_mesh_brute(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.mask, b.mask) and a.mask.any()
    for f in ("color", "xyz") + (("normal",) if normal else ()):
        assert (getattr(a, f) - getattr(b, f)).abs().max().item() < 2e-4, f


def test_launch_counters_count_launches(card):
    r0, a0 = raster_cuda.KERNEL.launches, attention_cuda.KERNEL.launches
    attention_cuda.attention_core_cuda(torch.zeros(1, 4, 24, device=card), 2)
    torch.cuda.synchronize()
    assert attention_cuda.KERNEL.launches == a0 + 1
    assert raster_cuda.KERNEL.launches == r0
