"""Axis-aligned crop warps as two matrix products.

Port of foundationpose_tpu/ops/warp.py::warp_crop. The crop transforms
are pure scale + translate, so dst(i, j) = src(v(i), u(j)) separates
into out = R @ img @ C with banded interpolation matrices. Convention:
pixel (i, j) has continuous coordinates (u, v) = (j, i), as kornia's
align_corners=False.
"""
from __future__ import annotations

import torch

from .. import torch_config  # noqa: F401


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
