"""foundationpose_torch.ops.rasterizer against foundationpose_tpu's renderer.

On the CPU `render_mesh` runs the plain brute path, the same function
the CUDA tile kernel (csrc/raster.cu) is held against on the card. It is
compared here with the JAX renderer's method="brute" (masks equal, then
the acceptance rule of bench.py:36-45 on color and depth) and with the
Pallas kernel in interpret mode (the case of tests/test_rasterizer.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from foundationpose_tpu.geometry.icosphere import icosphere
from foundationpose_tpu.meshio import compute_vertex_normals
from foundationpose_tpu.ops.rasterizer import render_mesh as j_render
from foundationpose_torch.ops import raster_cuda
from foundationpose_torch.ops.rasterizer import render_mesh as t_render
from foundationpose_torch.ops.rasterizer import render_mesh_brute

K = np.array([[300.0, 0, 48.0], [0, 300.0, 40.0], [0, 0, 1.0]], np.float32)


def _mesh(sub=2, seed=0):
    verts, faces = icosphere(sub, radius=0.1)
    verts = verts * (1.0 + 0.15 * np.sin(8 * verts[:, 2:3]))  # not a sphere
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0.1, 1.0, (len(verts), 3)).astype(np.float32)
    n = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    uv = np.stack(
        [np.arctan2(n[:, 1], n[:, 0]) / (2 * np.pi) + 0.5, n[:, 2] * 0.5 + 0.5], -1
    ).astype(np.float32)
    vn = compute_vertex_normals(verts, faces).astype(np.float32)
    return verts.astype(np.float32), faces.astype(np.int32), colors, uv, vn


def _poses(n, z=0.6, seed=0):
    rng = np.random.default_rng(seed)
    from foundationpose_tpu.geometry.rotations import so3_exp_map

    P = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    P[:, :3, :3] = np.asarray(so3_exp_map(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)))
    P[:, :3, 3] = np.stack(
        [rng.uniform(-0.02, 0.02, n), rng.uniform(-0.02, 0.02, n), z + rng.uniform(0, 0.2, n)], -1
    )
    return P


def _both(P, verts, faces, kw_np, out_hw=(80, 96), method="brute"):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw_np.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw_np.items()}
    oj = j_render(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(P), jnp.asarray(K),
        out_hw=out_hw, method=method, **jkw,
    )
    ot = t_render(
        torch.as_tensor(verts), torch.as_tensor(faces), torch.as_tensor(P),
        torch.as_tensor(K), out_hw=out_hw, **tkw,
    )
    return oj, ot


def _shift_filter(x, reduce):
    out = x.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = reduce(out, np.roll(np.roll(x, dy, axis=1), dx, axis=2))
    return out


def assert_render_parity(ref, out, fields=("color", "depth")):
    """bench.py:36-45: masks bit-equal; max |d| < 2e-4 on smooth pixels
    (mask interior, 3x3 depth range < 2 mm); < 4% of covered pixels
    differ by more than 1e-3."""
    mr = np.asarray(ref.mask)
    mo = out.mask.numpy()
    np.testing.assert_array_equal(mo, mr)
    interior = _shift_filter(mr.astype(np.uint8), np.minimum).astype(bool)
    bd = np.asarray(ref.depth)
    zmax = _shift_filter(np.where(mr, bd, -1e9), np.maximum)
    zmin = _shift_filter(np.where(mr, bd, 1e9), np.minimum)
    smooth = interior & ((zmax - zmin) < 2e-3)
    for f in fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(out, f).numpy()
        assert np.isfinite(b).all()
        sm = smooth[..., None] if a.ndim == 4 else smooth
        mm = mr[..., None] if a.ndim == 4 else mr
        assert np.abs((a - b) * sm).max() < 2e-4, f
        big = int((np.abs((a - b) * mm) > 1e-3).sum())
        assert big / max(int(mr.sum()), 1) < 0.04, f


@pytest.mark.parametrize(
    "case", ["vertex_color", "texture", "normals_cull", "no_light"]
)
def test_render_matches_jax_brute(case):
    verts, faces, colors, uv, vn = _mesh()
    rng = np.random.default_rng(1)
    P = _poses(5)
    kw = dict(vnormals=vn, use_light=True)
    fields = ("color", "depth")
    if case == "texture":
        kw.update(uv=uv, tex=rng.uniform(0, 1, (16, 24, 3)).astype(np.float32))
    else:
        kw.update(vertex_color=colors)
    if case == "normals_cull":
        kw.update(get_normal=True, cull_backfaces=True)
        fields = ("color", "depth", "normal")
    if case == "no_light":
        kw.update(use_light=False)
    oj, ot = _both(P, verts, faces, kw)
    assert ot.mask.any()
    assert_render_parity(oj, ot, fields)
    np.testing.assert_allclose(ot.xyz.numpy(), np.asarray(oj.xyz), atol=2e-4, rtol=0)


def test_render_crop_tf_and_probes():
    """Crop rendering plus the probes: one pose, an object behind the
    camera (empty, finite), a tiny on-screen object (dense faces)."""
    from foundationpose_tpu.geometry.projection import compute_crop_window_tf

    verts, faces, colors, _uv, vn = _mesh()
    kw = dict(vertex_color=colors, vnormals=vn, use_light=True)
    P = _poses(3)
    ctf = np.asarray(compute_crop_window_tf(jnp.asarray(P), jnp.asarray(K), 1.2, 32, 0.23))
    oj, ot = _both(P, verts, faces, dict(kw, crop_tf=ctf), out_hw=(32, 32))
    assert_render_parity(oj, ot)

    one = _poses(1)
    assert_render_parity(*_both(one, verts, faces, kw))

    behind = one.copy()
    behind[0, 2, 3] = -0.6
    oj, ot = _both(behind, verts, faces, kw)
    assert not ot.mask.any() and not np.asarray(oj.mask).any()
    assert np.isfinite(ot.color.numpy()).all() and np.isfinite(ot.xyz.numpy()).all()

    tiny = one.copy()
    tiny[0, 2, 3] = 8.0  # ~8 px across: many faces per pixel
    oj, ot = _both(tiny, verts, faces, kw)
    assert ot.mask.sum() > 10
    assert_render_parity(oj, ot)


def test_render_matches_jax_pallas_interpret():
    """The case of tests/test_rasterizer.py::TestPallasPath: 64x64,
    320 faces, JAX's Pallas kernel interpreted on the CPU."""
    verts, faces = icosphere(2, radius=0.1)
    rng = np.random.default_rng(0)
    colors = (rng.integers(30, 255, (len(verts), 3)).astype(np.float32) / 255).astype(np.float32)
    vn = compute_vertex_normals(verts, faces).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[0, 2, 3] = 0.6
    poses[1, 2, 3] = 0.9
    poses[1, :3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    Kp = np.array([[320.0, 0, 32.0], [0, 320.0, 32.0], [0, 0, 1.0]], np.float32)
    oj = j_render(
        jnp.asarray(verts.astype(np.float32)), jnp.asarray(faces.astype(np.int32)),
        jnp.asarray(poses), jnp.asarray(Kp), out_hw=(64, 64), vertex_color=jnp.asarray(colors),
        vnormals=jnp.asarray(vn), use_light=True, tile=32, max_faces_per_tile=128,
        method="pallas",
    )
    ot = t_render(
        torch.as_tensor(verts.astype(np.float32)), torch.as_tensor(faces.astype(np.int32)),
        torch.as_tensor(poses), torch.as_tensor(Kp), out_hw=(64, 64),
        vertex_color=torch.as_tensor(colors), vnormals=torch.as_tensor(vn), use_light=True,
    )
    np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
    np.testing.assert_allclose(ot.xyz.numpy(), np.asarray(oj.xyz), atol=2e-4, rtol=0)
    np.testing.assert_allclose(ot.color.numpy(), np.asarray(oj.color), atol=1e-4, rtol=0)


def test_cpu_takes_plain_path_without_launch():
    verts, faces, colors, _uv, vn = _mesh(sub=1)
    before = raster_cuda.KERNEL.launches
    args = (torch.as_tensor(verts), torch.as_tensor(faces), torch.as_tensor(_poses(2)),
            torch.as_tensor(K))
    kw = dict(out_hw=(40, 48), vertex_color=torch.as_tensor(colors), vnormals=torch.as_tensor(vn))
    a = t_render(*args, **kw)
    b = render_mesh_brute(*args, **kw)
    assert raster_cuda.KERNEL.launches == before
    for f in ("color", "xyz", "mask"):
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_kernel_records_pad_and_bound_chunks():
    """The torch side of the kernel's inputs (exercised here on the CPU):
    faces padded to 128 with ok = 0, and every chunk bbox contains the
    bboxes of its valid faces."""
    from foundationpose_torch.ops.rasterizer import _prepare

    verts, faces, colors, _uv, vn = _mesh(sub=2)
    prep = _prepare(
        torch.as_tensor(verts), torch.as_tensor(faces), torch.as_tensor(_poses(2)),
        torch.as_tensor(K), (80, 96), None, torch.as_tensor(colors), None,
        torch.as_tensor(vn), True, False, None, True,
    )
    rec, cbox, fpad = raster_cuda._records(prep)
    F = faces.shape[0]
    assert rec.shape == (2, 384, 13) and cbox.shape == (2, 3, 4) and fpad.shape == (384, 3)
    assert (rec[:, F:, 9] == 0).all()
    ok = prep.coeffs[..., 9] > 0
    bb = prep.bbox
    for c in range(3):
        sl = slice(c * 128, min((c + 1) * 128, F))
        o = ok[:, sl]
        for n in range(2):
            if o[n].any():
                assert (bb[n, sl][o[n], 0] >= cbox[n, c, 0]).all()
                assert (bb[n, sl][o[n], 1] <= cbox[n, c, 1]).all()
                assert (bb[n, sl][o[n], 2] >= cbox[n, c, 2]).all()
                assert (bb[n, sl][o[n], 3] <= cbox[n, c, 3]).all()
