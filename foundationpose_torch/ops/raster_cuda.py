"""Wrapper of the tile rasterizer kernel (csrc/raster.cu).

Replaces the Pallas TPU kernel foundationpose_tpu/ops/pallas_raster2.py
::_raster_kernel (call at raster_pose_pallas). One call launches two
kernels on the current stream, without a host synchronisation:

* `face_box_kernel` writes each face's padded screen box and each
  128-face chunk's box (the plain version is `_records` here);
* `raster_kernel` bins faces per 16x16 tile and per 8x4 warp patch by
  those boxes, edge-tests each pixel against its patch's faces only, and
  reproduces the plain path's arithmetic so that the result is exact
  (see the header of csrc/raster.cu).

`raster_shade` takes the `_Prepared` inputs of ops/rasterizer.py and
returns what `shade_brute` returns: color (after light), camera xyz, the
optional normal and the mask. A CPU tensor runs the plain version
(`shade_brute`); anything that is neither CPU nor CUDA raises.

Exactness of the binning. The kernel tests a face at a pixel only if
the face's box overlaps the pixel's 8x4 patch, while the plain path
(`_eval_faces`) tests every face at every pixel and accepts a pixel when
the three rounded edge functions w_k = fl(fl(fl(px*a_k) + fl(py*b_k)) +
c_k) are all >= -1e-5. For a near-degenerate face the coefficients are
divided by a tiny area, rounding dominates the test and the accepted
pixels can lie tens of pixels outside the face's bbox. So `face_boxes`
moves each side of the bbox out by a bound `need` on how far an accepted
pixel can lie beyond it, and flags the face as unbounded (box = the
whole plane, tested at every pixel as the brute path tests it) where the
bound is not finite. The argument, with l_k(p) = a_k x + b_k y + c_k in
exact arithmetic on the stored f32 coefficients and (x_k, y_k) the
face's screen vertices:

1. Rounding. Over the frame (0 <= x <= W-1 =: X, 0 <= y <= H-1 =: Y)
   |w_k - l_k(p)| <= e_k = g3 (|a_k| X + |b_k| Y + |c_k|), g3 = 3u/(1-3u),
   u = 2^-24 (three rounded operations; a tiny term covers underflow).
   So an accepted pixel has l_k(p) >= -delta_k, delta_k = 1e-5 + e_k.
2. Geometry. For a reference r and d_k = x_k - r, the residual
   q(p) = sum_k l_k(p) d_k - (x - r) is an affine function whose
   coefficients follow from the stored ones (it would vanish for exact
   barycentrics), so |q| over the frame peaks at one of its corners. With
   r = xmax every d_k <= 0 and x - xmax = sum_k l_k(p) d_k - q(p)
   <= sum_k delta_k |d_k| + max |q| =: need; with r = xmin (d_k >= 0)
   xmin - x <= the same expression; likewise for y.
3. Evaluation. `need` is computed in f64 from the f32 inputs; every
   rounding error there is below 2^-40 of the magnitudes involved, which
   are added to it, and the box's sides are rounded outward to f32.

Ordinary faces get a few thousandths of a pixel; the silhouette slivers
of a smooth mesh up to tens of pixels; nothing is unbounded unless its
coefficients are not finite. Invalid faces (ok = 0) get an empty box.
The kernel's `face_box_kernel` does the same f64 operations in the same
order (built with --fmad=false), so its boxes are bit-equal to
`_records` (chip_smoke.py checks it).
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, check_status

CHUNK = 128
TILE = 16  # a block's tile: TILE x TILE pixels, one thread each
PATCH = (8, 4)  # a warp's patch, (width, height) in pixels
BIG = 1e30
_G3 = 3 * 2.0**-24 / (1 - 3 * 2.0**-24)
_EPS = 1.00001e-5  # the edge test's |eps| (-1e-5 as f32), rounded up
_TINY = 1e-40  # covers underflow in the three rounded operations
_REL = 2.0**-40  # covers the f64 rounding of the bound itself
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

KERNEL = KernelLibrary("raster.cu", extra_flags=("--fmad=false",))


def _declare(lib):
    lib.fp_raster_boxes.restype = ctypes.c_int
    lib.fp_raster_boxes.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    lib.fp_raster_launch.restype = ctypes.c_int
    lib.fp_raster_launch.argtypes = [_P] * 12 + [_I] * 13 + [_F, _F, _P]


def face_boxes(coeffs, xy_f, H, W):
    """Screen boxes of faces that hold every pixel the edge test accepts.

    coeffs (..., F, 10) as ops/rasterizer.py::_face_coeffs gives them,
    xy_f (..., F, 3, 2) the faces' screen vertices, (H, W) the frame ->
    box (..., F, 4) f32 [x0, x1, y0, y1] and unbounded (..., F) bool.
    Each side of a valid face's bbox moves out by its `need` (module
    docstring) and is rounded outward to f32; a face whose bound is not
    finite is unbounded (box = the whole plane, +-BIG), an invalid face's
    box is empty. The operations and their order are those of
    face_box_kernel in csrc/raster.cu."""
    X, Y = float(max(W - 1, 0)), float(max(H - 1, 0))
    c = coeffs.double()
    a = [c[..., 3 * k] for k in range(3)]
    b = [c[..., 3 * k + 1] for k in range(3)]
    cc = [c[..., 3 * k + 2] for k in range(3)]
    xs = [xy_f[..., k, 0].double() for k in range(3)]
    ys = [xy_f[..., k, 1].double() for k in range(3)]
    delta = [_EPS + _G3 * ((a[k].abs() * X + b[k].abs() * Y) + cc[k].abs()) + _TINY for k in range(3)]

    def need(coords, ref, is_x):
        d = [coords[k] - ref for k in range(3)]
        spread = (delta[0] * d[0].abs() + delta[1] * d[1].abs()) + delta[2] * d[2].abs()
        ad, bd, cd = ([t[k] * d[k] for k in range(3)] for t in (a, b, cc))
        qa = (ad[0] + ad[1]) + ad[2]
        qb = (bd[0] + bd[1]) + bd[2]
        qc = (cd[0] + cd[1]) + cd[2] + ref
        if is_x:
            qa = qa - 1.0
        else:
            qb = qb - 1.0
        ta, tb = qa * X, qb * Y
        q_hi = (qc + torch.clamp(ta, min=0.0)) + torch.clamp(tb, min=0.0)
        q_lo = (qc + torch.clamp(ta, max=0.0)) + torch.clamp(tb, max=0.0)
        mag = (
            ((ad[0].abs() + ad[1].abs()) + ad[2].abs()) * X
            + ((bd[0].abs() + bd[1].abs()) + bd[2].abs()) * Y
            + ((cd[0].abs() + cd[1].abs()) + cd[2].abs())
            + ref.abs() + X + Y
        )
        return (spread + torch.maximum(q_hi.abs(), q_lo.abs())) * (1.0 + _REL) + mag * _REL

    def outward(v, up):
        f = v.float()
        past = f.double() < v if up else f.double() > v
        return torch.where(past, torch.nextafter(f, torch.full_like(f, float("inf") if up else -float("inf"))), f)

    lo_x = torch.minimum(torch.minimum(xs[0], xs[1]), xs[2])
    hi_x = torch.maximum(torch.maximum(xs[0], xs[1]), xs[2])
    lo_y = torch.minimum(torch.minimum(ys[0], ys[1]), ys[2])
    hi_y = torch.maximum(torch.maximum(ys[0], ys[1]), ys[2])
    needs = [need(xs, lo_x, True), need(xs, hi_x, True), need(ys, lo_y, False), need(ys, hi_y, False)]
    box = torch.stack([
        outward(lo_x - needs[0], False), outward(hi_x + needs[1], True),
        outward(lo_y - needs[2], False), outward(hi_y + needs[3], True),
    ], -1)
    finite = torch.isfinite(torch.stack(needs, -1)).all(-1)
    ok = coeffs[..., 9] > 0
    unbounded = ok & ~finite
    plane = box.new_tensor([-BIG, BIG, -BIG, BIG])
    empty = box.new_tensor([BIG, -BIG, BIG, -BIG])
    box = torch.where(unbounded[..., None], plane, box)
    return torch.where(ok[..., None], box, empty), unbounded


def _records(prep):
    """Plain version of face_box_kernel: face boxes (N, Fp, 4) with faces
    padded to a multiple of CHUNK (padding empty) and chunk boxes
    (N, C, 4), C = Fp / CHUNK, each the union of its faces' boxes."""
    N, F = prep.coeffs.shape[:2]
    Fp = -(-F // CHUNK) * CHUNK
    xy_f = prep.vdata[:, prep.faces, :2]
    fbox, _ = face_boxes(prep.coeffs, xy_f, prep.H, prep.W)
    if Fp > F:
        pad = fbox.new_tensor([BIG, -BIG, BIG, -BIG]).expand(N, Fp - F, 4)
        fbox = torch.cat([fbox, pad], dim=1)
    ch = fbox.reshape(N, Fp // CHUNK, CHUNK, 4)
    cbox = torch.stack(
        [ch[..., 0].amin(-1), ch[..., 1].amax(-1), ch[..., 2].amin(-1), ch[..., 3].amax(-1)], -1
    )
    return fbox.contiguous(), cbox.contiguous()


def _check(prep):
    dev = prep.vdata.device
    if prep.vdata.shape[0] > 65535:
        raise ValueError("raster kernel: more than 65535 poses in one call")
    for name, t, dt in (
        ("coeffs", prep.coeffs, torch.float32), ("zinv", prep.zinv, torch.float32),
        ("faces", prep.faces, torch.int64), ("vdata", prep.vdata, torch.float32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"raster kernel: {name} must be contiguous {dt} on {dev}")


def kernel_boxes(prep):
    """face_box_kernel's (fbox, cbox) for a CUDA `_Prepared`, as
    `_records` returns them. Face indices must lie in [0, V): render_mesh
    checks them (ops/rasterizer.py::validate_faces)."""
    _check(prep)
    dev = prep.vdata.device
    N, F = prep.coeffs.shape[:2]
    V, D = prep.vdata.shape[1:]
    C = -(-F // CHUNK)
    fbox = torch.empty((N, C * CHUNK, 4), dtype=torch.float32, device=dev)
    cbox = torch.empty((N, C, 4), dtype=torch.float32, device=dev)
    if N and C:
        lib = KERNEL.lib(_declare)
        status = lib.fp_raster_boxes(
            prep.coeffs.data_ptr(), prep.faces.data_ptr(), prep.vdata.data_ptr(),
            fbox.data_ptr(), cbox.data_ptr(), N, F, V, D, prep.H, prep.W, C,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        check_status("fp_raster_boxes", status)
    return fbox, cbox


def kernel_shade(prep, boxes, tex, w_ambient, w_diffuse, stats=None):
    """raster_kernel on a CUDA `_Prepared` and its `kernel_boxes`; stats,
    if given, is a zeroed (3,) int64 CUDA tensor the kernel adds its
    counts to: tile-list entries over all tiles, patch-list entries over
    all warps, and list rounds (see csrc/raster.cu)."""
    fbox, cbox = boxes
    dev = prep.vdata.device
    N, V, D = prep.vdata.shape
    H, W = prep.H, prep.W
    C = -(-prep.coeffs.shape[1] // CHUNK)
    if fbox.shape != (N, C * CHUNK, 4) or cbox.shape != (N, C, 4):
        raise ValueError("raster kernel: boxes must be kernel_boxes(prep)")
    color_mode = 2 if tex is not None else (1 if prep.c_col >= 0 else 0)
    Ht = Wt = 0
    if tex is not None:
        tex = tex.to(device=dev, dtype=torch.float32).contiguous()
        if tex.ndim != 3 or tex.shape[-1] != 3:
            raise ValueError("raster kernel: tex must be (Ht, Wt, 3)")
        Ht, Wt = tex.shape[:2]
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64 or stats.numel() != 3):
        raise ValueError("raster kernel: stats must be a (3,) int64 tensor on the card")
    color = torch.empty((N, H, W, 3), dtype=torch.float32, device=dev)
    xyz = torch.empty_like(color)
    normal = torch.empty_like(color) if prep.n_col >= 0 else None
    mask = torch.empty((N, H, W), dtype=torch.bool, device=dev)
    if N == 0 or H == 0 or W == 0:
        return color, xyz, normal, mask
    lib = KERNEL.lib(_declare)
    KERNEL.launches += 1
    status = lib.fp_raster_launch(
        prep.coeffs.data_ptr(), prep.zinv.data_ptr(), fbox.data_ptr(), cbox.data_ptr(),
        prep.faces.data_ptr(), prep.vdata.data_ptr(),
        tex.data_ptr() if tex is not None else None,
        color.data_ptr(), xyz.data_ptr(),
        normal.data_ptr() if normal is not None else None, mask.data_ptr(),
        stats.data_ptr() if stats is not None else None,
        N, prep.coeffs.shape[1], C, V, D, H, W,
        prep.c_col, color_mode, prep.d_col, prep.n_col, Ht, Wt,
        float(w_ambient), float(w_diffuse),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status("fp_raster_launch", status)
    return color, xyz, normal, mask


def raster_shade(prep, tex, w_ambient, w_diffuse):
    """-> (color, xyz, normal or None, mask) as shade_brute returns them.
    On the card: two launches and no host synchronisation."""
    dev = prep.vdata.device
    if dev.type == "cpu":
        from .rasterizer import shade_brute  # the plain version; imports this module

        return shade_brute(prep, tex, w_ambient, w_diffuse)
    if dev.type != "cuda":
        raise RuntimeError(f"raster kernel: no rasterizer for device {dev}")
    return kernel_shade(prep, kernel_boxes(prep), tex, w_ambient, w_diffuse)
