"""Wrapper of the tile rasterizer kernel (csrc/raster.cu).

Replaces the Pallas TPU kernel foundationpose_tpu/ops/pallas_raster2.py
::_raster_kernel (call at raster_pose_pallas). On the card the kernel is
bound by per-pixel edge tests; it skips face chunks whose bbox misses a
tile (faces are Morton-sorted, pipeline/mesh_tensors.py), stages the rest
in shared memory, and reproduces the plain path's arithmetic so that the
result is exact (see the header of csrc/raster.cu).

`raster_shade` takes the `_Prepared` inputs of ops/rasterizer.py: the
torch side computes the per-face records and chunk bboxes here, the
kernel writes color (after light), camera xyz, the optional normal and
the mask. A CPU tensor runs the plain version (`shade_brute`); anything
that is neither CPU nor CUDA raises.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, check_status

CHUNK = 128
REC = 13
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

KERNEL = KernelLibrary("raster.cu", extra_flags=("--fmad=false",))


def _declare(lib):
    lib.fp_raster_launch.restype = ctypes.c_int
    lib.fp_raster_launch.argtypes = [_P] * 9 + [_I] * 12 + [_F, _F, _P]


def _records(prep):
    """Per-face records (N, Fp, 13), chunk bboxes (N, C, 4) and faces
    (Fp, 3) int32, with faces padded to a multiple of CHUNK."""
    N, F = prep.coeffs.shape[:2]
    Fp = -(-F // CHUNK) * CHUNK
    pad = Fp - F
    rec = torch.cat([prep.coeffs, prep.zinv], dim=-1)
    faces = prep.faces.to(torch.int32)
    # The edge tests accept pixels up to 1e-5 (in barycentric units)
    # outside a face, and rounding adds a little more: pad each bbox by
    # one pixel plus a fraction of its extent, so the chunk skip is
    # conservative and the kernel stays exact.
    bb = prep.bbox
    margin = 1.0 + 1e-4 * ((bb[..., 1] - bb[..., 0]) + (bb[..., 3] - bb[..., 2]))
    ok = prep.coeffs[..., 9] > 0
    big = torch.full_like(margin, 1e30)
    x0 = torch.where(ok, bb[..., 0] - margin, big)
    x1 = torch.where(ok, bb[..., 1] + margin, -big)
    y0 = torch.where(ok, bb[..., 2] - margin, big)
    y1 = torch.where(ok, bb[..., 3] + margin, -big)
    if pad:
        rec = torch.cat([rec, rec.new_zeros(N, pad, REC)], dim=1)
        faces = torch.cat([faces, faces.new_zeros(pad, 3)])
        x0, y0 = (torch.cat([a, a.new_full((N, pad), 1e30)], 1) for a in (x0, y0))
        x1, y1 = (torch.cat([a, a.new_full((N, pad), -1e30)], 1) for a in (x1, y1))
    C = Fp // CHUNK
    cbox = torch.stack(
        [
            x0.reshape(N, C, CHUNK).amin(-1),
            x1.reshape(N, C, CHUNK).amax(-1),
            y0.reshape(N, C, CHUNK).amin(-1),
            y1.reshape(N, C, CHUNK).amax(-1),
        ],
        dim=-1,
    )
    return rec.contiguous(), cbox.contiguous(), faces.contiguous()


def raster_shade(prep, tex, w_ambient, w_diffuse):
    """-> (color, xyz, normal or None, mask) as shade_brute returns them."""
    dev = prep.vdata.device
    if dev.type == "cpu":
        from .rasterizer import shade_brute  # the plain version; imports this module

        return shade_brute(prep, tex, w_ambient, w_diffuse)
    if dev.type != "cuda":
        raise RuntimeError(f"raster kernel: no rasterizer for device {dev}")
    if prep.vdata.shape[0] > 65535:
        raise ValueError("raster kernel: more than 65535 poses in one call")
    rec, cbox, faces = _records(prep)
    vdata = prep.vdata
    N, V, D = vdata.shape
    H, W = prep.H, prep.W
    lo, hi = torch.aminmax(prep.faces)  # the kernel indexes vdata with them
    if int(lo) < 0 or int(hi) >= V:
        raise ValueError(f"raster kernel: face indices must lie in [0, {V})")
    for name, t, dt in (
        ("rec", rec, torch.float32), ("cbox", cbox, torch.float32),
        ("faces", faces, torch.int32), ("vdata", vdata, torch.float32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"raster kernel: {name} must be contiguous {dt} on {dev}")
    color_mode = 2 if tex is not None else (1 if prep.c_col >= 0 else 0)
    Ht = Wt = 0
    if tex is not None:
        tex = tex.to(device=dev, dtype=torch.float32).contiguous()
        if tex.ndim != 3 or tex.shape[-1] != 3:
            raise ValueError("raster kernel: tex must be (Ht, Wt, 3)")
        Ht, Wt = tex.shape[:2]
    color = torch.empty((N, H, W, 3), dtype=torch.float32, device=dev)
    xyz = torch.empty_like(color)
    normal = torch.empty_like(color) if prep.n_col >= 0 else None
    mask = torch.empty((N, H, W), dtype=torch.bool, device=dev)
    if N == 0 or H == 0 or W == 0:
        return color, xyz, normal, mask
    lib = KERNEL.lib(_declare)
    KERNEL.launches += 1
    status = lib.fp_raster_launch(
        rec.data_ptr(), cbox.data_ptr(), faces.data_ptr(), vdata.data_ptr(),
        tex.data_ptr() if tex is not None else None,
        color.data_ptr(), xyz.data_ptr(),
        normal.data_ptr() if normal is not None else None, mask.data_ptr(),
        N, rec.shape[1], V, D, H, W,
        prep.c_col, color_mode, prep.d_col, prep.n_col, Ht, Wt,
        float(w_ambient), float(w_diffuse),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status("fp_raster_launch", status)
    return color, xyz, normal, mask
