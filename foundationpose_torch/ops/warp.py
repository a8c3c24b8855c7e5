"""Image warps: homographies by gathers, axis-aligned crops as two
matrix products.

Port of foundationpose_tpu/ops/warp.py. `warp_perspective` and
`warp_perspective_batch` sample dst(p) = src(M^-1 p) with bilinear or
nearest gathers, zeros outside (the reference's kornia
warp_perspective). `warp_crop` is the register and track path: the crop
transforms are pure scale + translate, so dst(i, j) = src(v(i), u(j))
separates into out = R @ img @ C with banded interpolation matrices.
Convention: pixel (i, j) has continuous coordinates (u, v) = (j, i), as
kornia's align_corners=False.
"""
from __future__ import annotations

import torch

from .. import torch_config  # noqa: F401


def _inverse(M: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) f32 inverses. A scale + translate matrix is inverted in
    closed form, rounded as the JAX package's jnp.linalg.inv rounds it
    (reciprocal, then times -t; warp_crop's rounding), so nearest-mode
    ties resolve the same way; any other matrix by torch.linalg.inv.
    Chosen per matrix on the device, without a host round trip."""
    inv_x, inv_y = 1.0 / M[:, 0, 0], 1.0 / M[:, 1, 1]
    closed = torch.zeros_like(M)
    closed[:, 0, 0], closed[:, 0, 2] = inv_x, -M[:, 0, 2] * inv_x
    closed[:, 1, 1], closed[:, 1, 2] = inv_y, -M[:, 1, 2] * inv_y
    closed[:, 2, 2] = 1.0
    off = M[:, [0, 1, 2, 2], [1, 0, 0, 1]]
    aligned = torch.all(off == 0, dim=1) & (M[:, 2, 2] == 1)
    general = torch.linalg.inv(torch.where(aligned[:, None, None], torch.eye(3, device=M.device), M))
    return torch.where(aligned[:, None, None], closed, general)


def _source_coords(Minv: torch.Tensor, out_hw):
    """(N, oh, ow) continuous source coordinates u, v of every output pixel."""
    out_h, out_w = out_hw
    jj = torch.arange(out_w, dtype=torch.float32, device=Minv.device)[None, None]
    ii = torch.arange(out_h, dtype=torch.float32, device=Minv.device)[None, :, None]

    def row(r):
        return Minv[:, r, 0, None, None] * jj + Minv[:, r, 1, None, None] * ii + Minv[:, r, 2, None, None]

    w = row(2)
    return row(0) / w, row(1) / w


def _tap(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor) -> torch.Tensor:
    """img (N or 1, H, W, C) at integer (vi, ui) (N, oh, ow); zeros outside."""
    n, H, W, _C = img.shape
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    flat = torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)
    if n > 1:
        flat = flat + torch.arange(n, device=img.device)[:, None, None] * (H * W)
    val = img.reshape(-1, img.shape[-1])[flat]
    return torch.where(inb[..., None], val, torch.zeros_like(val))


def _sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "nearest":
        return _tap(img, torch.round(v).to(torch.int64), torch.round(u).to(torch.int64))
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    ui, vi = u0.to(torch.int64), v0.to(torch.int64)
    top = _tap(img, vi, ui) * (1 - fu) + _tap(img, vi, ui + 1) * fu
    bot = _tap(img, vi + 1, ui) * (1 - fu) + _tap(img, vi + 1, ui + 1) * fu
    return top * (1 - fv) + bot * fv


def warp_perspective(
    img: torch.Tensor, M: torch.Tensor, out_hw: tuple[int, int], mode: str = "bilinear"
) -> torch.Tensor:
    """dst(p) = src(M^-1 p) for a batch of transforms: img (H, W, C), one
    source shared by the batch; M (B, 3, 3) src->dst homographies.
    Returns (B, out_h, out_w, C) f32, zeros where the source point falls
    outside the image."""
    Minv = _inverse(M.to(torch.float32))
    u, v = _source_coords(Minv, out_hw)
    return _sample(img.to(torch.float32)[None], u, v, mode)


def warp_perspective_batch(
    imgs: torch.Tensor, M: torch.Tensor, out_hw: tuple[int, int], mode: str = "bilinear"
) -> torch.Tensor:
    """One source per transform: imgs (B, H, W, C), M (B, 3, 3) ->
    (B, out_h, out_w, C)."""
    Minv = _inverse(M.to(torch.float32))
    u, v = _source_coords(Minv, out_hw)
    return _sample(imgs.to(torch.float32), u, v, mode)


def _axis_interp_matrix(src_coords: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """(N, out) continuous source coordinates -> (N, out, size)
    interpolation weights (zero rows when out of bounds)."""
    idx = torch.arange(size, dtype=torch.float32, device=src_coords.device)[None, None]
    if mode == "bilinear":
        w = torch.clamp(1.0 - torch.abs(src_coords[..., None] - idx), min=0.0)
        inb = (src_coords >= -1.0) & (src_coords <= size)
    else:  # nearest
        w = (torch.round(src_coords)[..., None] == idx).to(torch.float32)
        inb = (src_coords >= -0.5) & (src_coords <= size - 0.5)
    return w * inb[..., None].to(torch.float32)


def warp_crop(
    img: torch.Tensor, M: torch.Tensor, out_hw: tuple[int, int], mode: str = "bilinear"
) -> torch.Tensor:
    """img (H, W, C) shared source; M (N, 3, 3) src->dst axis-aligned
    affine. Returns (N, out_h, out_w, C). Exact for both modes (one-hot
    rows for nearest)."""
    out_h, out_w = out_hw
    H, W, Cch = img.shape
    img = img.to(torch.float32)
    M = M.to(torch.float32)
    # Closed-form inverse of the scale+translate map, rounded as the
    # reference's jnp.linalg.inv rounds it (reciprocal, then times -t):
    # crop scales like 32/48 put nearest-mode source rows exactly on .5,
    # and these bits decide which way each tie goes.
    inv_x = 1.0 / M[:, 0, 0]
    inv_y = 1.0 / M[:, 1, 1]
    jj = torch.arange(out_w, dtype=torch.float32, device=img.device)
    ii = torch.arange(out_h, dtype=torch.float32, device=img.device)
    v_src = inv_y[:, None] * ii[None] + (-M[:, 1, 2] * inv_y)[:, None]  # (N, oh)
    u_src = inv_x[:, None] * jj[None] + (-M[:, 0, 2] * inv_x)[:, None]  # (N, ow)
    R = _axis_interp_matrix(v_src, H, mode)  # (N, oh, H)
    Cm = _axis_interp_matrix(u_src, W, mode)  # (N, ow, W)
    t1 = torch.matmul(R, img.reshape(H, W * Cch))  # (N, oh, W*C)
    t1 = t1.reshape(-1, out_h, W, Cch)
    return torch.einsum("niwc,njw->nijc", t1, Cm)
