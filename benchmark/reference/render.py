"""Plain triangle rasterizer of the reference, in torch.

Each pose's vertices are projected with K (OpenCV pixel space, pixel
(row i, col j) at (u, v) = (j, i)) and, for crops, the crop's affine.
Every (face, pixel) pair inside the face's screen box, grown by a pixel,
is tested with the face's normalized edge functions (inside where all
three are >= -1e-5); the nearest covering face wins, the lowest face
index on an exact tie. Attributes are interpolated perspective-correctly
from the winner's vertices, and colors shaded as Gouraud with an
ambient weight 0.8 and a diffuse weight 0.5 from a light along the
viewing axis. Faces behind z = 1e-4 are dropped, and back faces when
culling. The pairs are enumerated explicitly, in blocks of poses, so the
work is the covered area, not pixels x faces.
"""
from __future__ import annotations

import torch

_BLOCK = 1 << 24  # candidate (face, pixel) pairs per block
_EPS = -1e-5


def _screen(pos, poses, K, crop_tf):
    cam = torch.einsum("nij,vj->nvi", poses[:, :3, :3], pos) + poses[:, None, :3, 3]
    z = torch.clamp(cam[..., 2], min=1e-8)
    u = cam[..., 0] * K[0, 0] / z + K[0, 2]
    v = cam[..., 1] * K[1, 1] / z + K[1, 2]
    if crop_tf is not None:
        u = crop_tf[:, None, 0, 0] * u + crop_tf[:, None, 0, 2]
        v = crop_tf[:, None, 1, 1] * v + crop_tf[:, None, 1, 2]
    return cam, u, v


def _barycentric(xa, ya, xb, yb, xc, yc, px, py):
    area = (xb - xa) * (yc - ya) - (xc - xa) * (yb - ya)
    inv = torch.where(area.abs() < 1e-12, torch.zeros_like(area), 1.0 / area)
    w0 = ((xb - px) * (yc - py) - (xc - px) * (yb - py)) * inv
    w1 = ((xc - px) * (ya - py) - (xa - px) * (yc - py)) * inv
    return w0, w1, 1.0 - w0 - w1, area


def render(pos, faces, vcolor, vnormals, poses, K, hw, crop_tf=None, cull=False):
    """pos (V, 3), faces (F, 3), vcolor (V, 3) in [0, 1], vnormals (V, 3),
    poses (N, 4, 4), K (3, 3), hw (H, W), crop_tf (N, 3, 3) or None ->
    color (N, H, W, 3), xyz (N, H, W, 3), mask (N, H, W); zeros outside."""
    H, W = hw
    N = poses.shape[0]
    dev = poses.device
    faces = faces.to(torch.int64)
    color = torch.zeros((N, H, W, 3), device=dev)
    xyz = torch.zeros((N, H, W, 3), device=dev)
    mask = torch.zeros((N, H, W), dtype=torch.bool, device=dev)
    cam, u, v = _screen(pos, poses, K, crop_tf)
    zf = cam[:, faces, 2]  # (N, F, 3)
    ok = (zf > 1e-4).all(-1)
    if cull:
        p = cam[:, faces]
        n = torch.linalg.cross(p[:, :, 1] - p[:, :, 0], p[:, :, 2] - p[:, :, 0], dim=-1)
        ok &= (n * p[:, :, 0]).sum(-1) < 0
    uf, vf = u[:, faces], v[:, faces]  # (N, F, 3)
    x0 = torch.clamp(torch.floor(uf.amin(-1)) - 1, 0, W - 1)
    x1 = torch.clamp(torch.ceil(uf.amax(-1)) + 1, 0, W - 1)
    y0 = torch.clamp(torch.floor(vf.amin(-1)) - 1, 0, H - 1)
    y1 = torch.clamp(torch.ceil(vf.amax(-1)) + 1, 0, H - 1)
    bw = (x1 - x0 + 1).to(torch.int64)
    bh = (y1 - y0 + 1).to(torch.int64)
    count = torch.where(ok, bw * bh, torch.zeros_like(bw))
    rows = torch.cumsum(count.sum(1), 0).tolist()
    light_n = torch.einsum("nij,vj->nvi", poses[:, :3, :3], vnormals)
    diffuse = torch.clamp(light_n[..., 2] / torch.clamp(torch.linalg.norm(light_n, dim=-1), min=1e-12)
                          * -1.0, 0.0, 1.0)  # light (0, 0, 1): n . -l
    s = 0
    while s < N:
        e = s + 1
        while e < N and rows[e] - (rows[s - 1] if s else 0) <= _BLOCK:
            e += 1
        _block(s, e, faces, cam, u, v, vcolor, diffuse, count, x0, y0, bw, H, W, color, xyz, mask)
        s = e
    return color, xyz, mask


def _block(s, e, faces, cam, u, v, vcolor, diffuse, count, x0, y0, bw, H, W, color, xyz, mask):
    dev = cam.device
    c = count[s:e].reshape(-1)
    nf = torch.repeat_interleave(torch.arange(c.numel(), device=dev), c)
    if nf.numel() == 0:
        return
    start = torch.cumsum(c, 0) - c
    local = torch.arange(nf.numel(), device=dev) - start[nf]
    F = faces.shape[0]
    n = nf // F + s
    f = nf % F
    w_box = bw[s:e].reshape(-1)[nf]
    px = x0[s:e].reshape(-1)[nf] + (local % w_box).to(torch.float32)
    py = y0[s:e].reshape(-1)[nf] + (local // w_box).to(torch.float32)
    tri = faces[f]  # (P, 3)
    ua, ub, uc = (u[n, tri[:, k]] for k in range(3))
    va, vb, vc = (v[n, tri[:, k]] for k in range(3))
    za, zb, zc = (cam[n, tri[:, k], 2] for k in range(3))
    w0, w1, w2, area = _barycentric(ua, va, ub, vb, uc, vc, px, py)
    zsum = w0 / za + w1 / zb + w2 / zc
    hit = (w0 >= _EPS) & (w1 >= _EPS) & (w2 >= _EPS) & (area.abs() > 1e-12) & (zsum > 1e-12)
    z = torch.where(hit, 1.0 / zsum, torch.full_like(zsum, float("inf")))
    key = (n * H + py.to(torch.int64)) * W + px.to(torch.int64)
    best = torch.full((color.shape[0] * H * W,), float("inf"), device=dev)
    best.scatter_reduce_(0, key, z, "amin")
    win = hit & (z == best[key])
    first = torch.full_like(best, F, dtype=torch.int64)
    first.scatter_reduce_(0, key[win], f[win], "amin")
    sel = win & (f == first[key])
    key, n, tri = key[sel], n[sel], tri[sel]
    w0, w1, w2 = w0[sel], w1[sel], w2[sel]
    za, zb, zc = za[sel], zb[sel], zc[sel]
    zs = w0 / za + w1 / zb + w2 / zc
    c0, c1 = (w0 / za / zs)[:, None], (w1 / zb / zs)[:, None]
    c2 = 1.0 - c0 - c1

    def interp(attr):  # attr (N, V, C) or (V, C)
        if attr.dim() == 2:
            a, b, cc = attr[tri[:, 0]], attr[tri[:, 1]], attr[tri[:, 2]]
        else:
            a, b, cc = (attr[n, tri[:, k]] for k in range(3))
        return a * c0 + b * c1 + cc * c2

    p_xyz = interp(cam)
    col = interp(vcolor)
    d = interp(diffuse[..., None])
    col = torch.clamp(col * 0.8 + d * col * 0.5, 0.0, 1.0)
    color.view(-1, 3)[key] = col
    xyz.view(-1, 3)[key] = p_xyz
    mask.view(-1)[key] = True
