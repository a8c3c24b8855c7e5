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

from chip_smoke import ESCAPERS, sliver_scene
from foundationpose_tpu.geometry.icosphere import icosphere
from foundationpose_tpu.meshio import compute_vertex_normals
from foundationpose_tpu.ops.rasterizer import render_mesh as j_render
from foundationpose_torch.ops import raster_cuda
from foundationpose_torch.ops.rasterizer import render_mesh as t_render
from foundationpose_torch.ops.rasterizer import _eval_faces, _pixel_grid, render_mesh_brute

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
    """The plain version of the kernel's face boxes (exercised here on
    the CPU): faces padded to 128 with empty boxes, every valid face's
    box holds its bbox, no face of an ordinary mesh is unbounded, and
    every chunk box holds the boxes of its faces."""
    from foundationpose_torch.ops.rasterizer import _prepare

    verts, faces, colors, _uv, vn = _mesh(sub=2)
    prep = _prepare(
        torch.as_tensor(verts), torch.as_tensor(faces), torch.as_tensor(_poses(2)),
        torch.as_tensor(K), (80, 96), None, torch.as_tensor(colors), None,
        torch.as_tensor(vn), True, False, None, True,
    )
    fbox, cbox = raster_cuda._records(prep)
    F = faces.shape[0]
    assert fbox.shape == (2, 384, 4) and cbox.shape == (2, 3, 4)
    empty = torch.tensor([BIG, -BIG, BIG, -BIG])
    assert (fbox[:, F:] == empty).all()
    ok = prep.coeffs[..., 9] > 0
    assert 0 < int(ok.sum()) < 2 * F  # culling leaves some faces out
    assert (fbox[:, :F][~ok] == empty).all()
    bb, box = prep.bbox[ok], fbox[:, :F][ok]
    assert (box[:, 0] <= bb[:, 0]).all() and (box[:, 1] >= bb[:, 1]).all()
    assert (box[:, 2] <= bb[:, 2]).all() and (box[:, 3] >= bb[:, 3]).all()
    assert (box - bb).abs().max() < 0.5  # a tight pad on an ordinary mesh
    _, unbounded = raster_cuda.face_boxes(prep.coeffs, prep.vdata[:, prep.faces, :2], 80, 96)
    assert not unbounded.any()
    for c in range(3):
        ch = fbox[:, c * 128 : (c + 1) * 128]
        assert (ch[..., 0].amin(-1) == cbox[:, c, 0]).all() and (ch[..., 1].amax(-1) == cbox[:, c, 1]).all()
        assert (ch[..., 2].amin(-1) == cbox[:, c, 2]).all() and (ch[..., 3].amax(-1) == cbox[:, c, 3]).all()


BIG = raster_cuda.BIG


def _slivers(n, seed, H=160, W=160):
    """n faces (n, 3, 2) f32 in an H x W frame whose third vertex lies
    1e-9 to 1e-2 px off the segment of the other two."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, [W, H], (n, 2))
    b = rng.uniform(0, [W, H], (n, 2))
    e = b - a
    normal = np.stack([-e[:, 1], e[:, 0]], -1) / np.linalg.norm(e, axis=-1, keepdims=True)
    off = 10 ** rng.uniform(-9, -2, (n, 1)) * rng.choice([-1, 1], (n, 1))
    c = a + rng.uniform(0, 1, (n, 1)) * e + off * normal
    return np.stack([a, b, c], 1).astype(np.float32)


def _accepted(coeffs, zinv, H, W):
    """(F, H*W) pixels the plain path's edge test accepts; _eval_faces
    hits only among them."""
    pu, pv = _pixel_grid(H, W, "cpu")
    z = _eval_faces(coeffs[:, None], zinv[:, None], pu, pv)
    w = [pu * coeffs[:, None, 3 * k] + pv * coeffs[:, None, 3 * k + 1] + coeffs[:, None, 3 * k + 2]
         for k in range(3)]
    acc = (w[0] >= -1e-5) & (w[1] >= -1e-5) & (w[2] >= -1e-5) & (coeffs[:, None, 9] > 0)
    assert ((z < BIG) <= acc).all()  # a hit is an accepted pixel
    return acc, pu, pv


def test_sliver_sweep_boxes_hold_every_accepted_pixel():
    """3000 seeded slivers and chip_smoke.py's ESCAPERS (which end with
    the quoted sliver): every pixel the plain edge test accepts lies
    inside the face's box, or the face is unbounded. The escapers do
    leave their bbox by > 5 px."""
    from foundationpose_torch.ops.rasterizer import _face_coeffs

    xy = torch.as_tensor(np.concatenate([np.float32(ESCAPERS), _slivers(3000, 0)]))
    F = xy.shape[0]
    coeffs, zinv = _face_coeffs(xy, torch.full((F, 3), 0.5), torch.ones(F, dtype=torch.bool))
    box, unbounded = raster_cuda.face_boxes(coeffs, xy, 160, 160)
    bb = torch.stack([xy[..., 0].amin(-1), xy[..., 0].amax(-1), xy[..., 1].amin(-1), xy[..., 1].amax(-1)], -1)
    n_acc = 0
    for s in range(0, F, 512):
        acc, pu, pv = _accepted(coeffs[s : s + 512], zinv[s : s + 512], 160, 160)
        bx, b0 = box[s : s + 512, None], bb[s : s + 512, None]
        inside = (pu >= bx[..., 0]) & (pu <= bx[..., 1]) & (pv >= bx[..., 2]) & (pv <= bx[..., 3])
        assert not (acc & ~inside & ~unbounded[s : s + 512, None]).any()
        n_acc += int(acc.sum())
        if s == 0:
            out = torch.maximum(torch.maximum(b0[..., 0] - pu, pu - b0[..., 1]),
                                torch.maximum(b0[..., 2] - pv, pv - b0[..., 3]))
            escape = torch.where(acc, out, torch.full_like(out, -BIG)).amax(-1)
            assert (escape[: len(ESCAPERS) - 1] > 5).all()  # the quoted one is last
    assert n_acc > 0 and int((coeffs[:, 9] > 0).sum()) > 2000


def _replay_kernel(prep, cap, step):
    """Torch replay of csrc/raster.cu's schedule on the CPU: per 32x32
    tile, chunks by their boxes, faces by theirs, the tile list filled
    `step` candidates at a time and handed to phase B whenever the next
    step would overflow `cap` entries (the kernel: NTHREADS and CAP);
    per 8x4 patch, the list entries whose box overlaps it, scanned in
    ascending order with the strict replace. Returns shade_brute's
    outputs and the number of rounds."""
    from foundationpose_torch.ops.rasterizer import _finalize, _interpolate

    fbox, cbox = raster_cuda._records(prep)
    N, F = prep.coeffs.shape[:2]
    H, W, T = prep.H, prep.W, raster_cuda.TILE
    PW, PH = raster_cuda.PATCH
    C = cbox.shape[1]

    def overlaps(b, x0, x1, y0, y1):
        return ~((b[..., 0] > x1) | (b[..., 1] < x0) | (b[..., 2] > y1) | (b[..., 3] < y0))

    ly, lx = torch.meshgrid(torch.arange(T), torch.arange(T), indexing="ij")
    lx, ly = lx.reshape(-1), ly.reshape(-1)
    best = torch.zeros((N, H, W), dtype=torch.int64)
    covered = torch.zeros((N, H, W), dtype=torch.bool)
    rounds = 0
    for n in range(N):
        for ty0 in range(0, H, T):
            for tx0 in range(0, W, T):
                live = torch.nonzero(overlaps(cbox[n], tx0, tx0 + T - 1, ty0, ty0 + T - 1))[:, 0]
                cand = (live[:, None] * raster_cuda.CHUNK + torch.arange(raster_cuda.CHUNK)).reshape(-1)
                hit = overlaps(fbox[n, cand], tx0, tx0 + T - 1, ty0, ty0 + T - 1)
                lists, cur = [], []
                for s in range(0, len(cand), step):
                    add = cand[s : s + step][hit[s : s + step]].tolist()
                    if len(cur) + len(add) > cap:
                        lists.append(cur)
                        cur = []
                    cur += add
                lists.append(cur)
                rounds += len(lists)
                px, py = (tx0 + lx).float(), (ty0 + ly).float()
                pbx = tx0 + (lx // PW) * PW  # each pixel's patch origin
                pby = ty0 + (ly // PH) * PH
                bz = torch.full((T * T,), BIG)
                bf = torch.zeros(T * T, dtype=torch.int64)
                for lst in lists:
                    for f in lst:  # ascending; the strict replace
                        in_patch = overlaps(fbox[n, f], pbx, pbx + PW - 1, pby, pby + PH - 1)
                        z = _eval_faces(prep.coeffs[n, f], prep.zinv[n, f], px, py)
                        better = in_patch & (z < bz)
                        bz = torch.where(better, z, bz)
                        bf = torch.where(better, f, bf)
                keep = (px < W) & (py < H)
                yy, xx = py[keep].long(), px[keep].long()
                best[n, yy, xx] = bf[keep]
                covered[n, yy, xx] = bz[keep] < BIG
    pu, pv = _pixel_grid(H, W, "cpu")
    interp = _interpolate(prep, best.reshape(N, -1), pu, pv)
    return _finalize(prep, interp, covered.reshape(N, -1), None, 0.8, 0.5), rounds


def _prep_for(case):
    from foundationpose_torch.ops.rasterizer import _prepare

    if case == "slivers":
        verts, faces = sliver_scene()
        colors = np.random.default_rng(3).uniform(0.1, 1, (len(verts), 3)).astype(np.float32)
        vn = np.tile(np.float32([0, 0, -1]), (len(verts), 1))
        P, Kc, hw, cull = np.eye(4, dtype=np.float32)[None], np.eye(3, dtype=np.float32), (160, 160), False
    else:
        verts, faces, colors, _uv, vn = _mesh()
        P, Kc, hw, cull = _poses(3), K, (80, 96), case == "cull"
        if case == "tiny":
            P = _poses(1)
            P[0, 2, 3] = 8.0  # ~8 px across: every face in one tile
    T = torch.as_tensor
    return _prepare(T(verts), T(faces), T(P), T(Kc), hw, None, T(colors), None, T(vn),
                    True, True, None, cull)


@pytest.mark.parametrize("case", ["no_cull", "cull", "tiny", "slivers"])
def test_kernel_schedule_replay_bit_equal_to_brute(case):
    """The kernel's binning replayed in torch is bit-equal to shade_brute
    (mask, color, xyz, normal); a list of 48 entries filled 16 faces at
    a time forces rounds on the tiny object; on chip_smoke.py's sliver
    scene the brute path covers pixels far outside a sliver's bbox."""
    from foundationpose_torch.ops.rasterizer import shade_brute

    prep = _prep_for(case)
    want = shade_brute(prep, None, 0.8, 0.5)
    got, rounds = _replay_kernel(prep, cap=48, step=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert want[3].any()
    if case == "tiny":
        assert rounds > 3
    if case == "slivers":  # pixels won by a face more than 2 px outside its bbox
        from foundationpose_torch.ops.rasterizer import _rasterize_brute

        pu, pv = _pixel_grid(160, 160, "cpu")
        best, cov = _rasterize_brute(prep.coeffs, prep.zinv, pu, pv, 512)
        bb = prep.bbox[0, best[0]]
        out = torch.maximum(torch.maximum(bb[:, 0] - pu, pu - bb[:, 1]), torch.maximum(bb[:, 2] - pv, pv - bb[:, 3]))
        assert int((cov[0] & (out > 2)).sum()) > 0


def test_validated_faces_render_reads_nothing_back(monkeypatch):
    """Faces from make_mesh_tensors are checked when they are built;
    render_mesh then makes no host read of tensor data (every
    tensor-to-Python conversion is made to raise)."""
    from foundationpose_torch.meshio import TriMesh
    from foundationpose_torch.pipeline.mesh_tensors import make_mesh_tensors

    verts, faces, colors, _uv, vn = _mesh(sub=1)
    mt = make_mesh_tensors(TriMesh(vertices=verts, faces=faces, vertex_colors=(colors * 255).astype(np.uint8)))
    args = (mt.pos, mt.faces, torch.as_tensor(_poses(2)), torch.as_tensor(K))
    kw = dict(out_hw=(40, 48), vertex_color=mt.vertex_color, vnormals=mt.vnormals)
    want = t_render(*args, **kw)

    def read(*a, **k):
        raise AssertionError("a host read of tensor data")

    for name in ("item", "tolist", "numpy", "__int__", "__float__", "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, read)
    got = t_render(*args, **kw)
    monkeypatch.undo()
    for f in ("color", "xyz", "mask"):
        assert torch.equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("bad", [-1, 42])
def test_out_of_range_face_index_raises(bad):
    """render_mesh rejects a face index outside [0, V): on a new tensor,
    and on a checked tensor written in place afterwards."""
    verts, faces, colors, _uv, vn = _mesh(sub=1)
    T = torch.as_tensor
    args = (T(verts), None, T(_poses(1)), T(K))
    kw = dict(out_hw=(40, 48), vertex_color=T(colors), vnormals=T(vn))
    broken = faces.copy()
    broken[5, 1] = bad
    with pytest.raises(ValueError, match="face indices"):
        t_render(args[0], T(broken), *args[2:], **kw)
    good = T(faces.astype(np.int64))
    t_render(args[0], good, *args[2:], **kw)
    good[5, 1] = bad
    with pytest.raises(ValueError, match="face indices"):
        render_mesh_brute(args[0], good, *args[2:], **kw)
