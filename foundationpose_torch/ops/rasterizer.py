"""Batched triangle rasterizer on torch tensors.

Port of foundationpose_tpu/ops/rasterizer.py (method="brute"). Rendering
happens directly in OpenCV pixel space: the pinhole projection plus the
per-pose crop affine put every hypothesis straight into its network
crop. Perspective-correct interpolation re-weights screen barycentrics
by 1/z.

Two functions share one preparation stage (`_prepare`: screen vertices,
per-face edge coefficients, per-vertex attributes):

* `render_mesh_brute` is the plain version: every pixel tests every
  face in chunks, the nearest covering face wins (lowest index on an
  exact tie), and its attributes are interpolated.
* `render_mesh` is the entry point of the pipeline. A CUDA tensor goes
  to the tile kernel of ops/raster_cuda.py, which consumes the same
  coefficient tensors and reproduces the brute path's arithmetic; a
  CPU tensor takes the plain version. Any other device raises.

Both check the face indices first (`validate_faces`), once per faces
tensor, so that a render of checked mesh tensors reads nothing back from
the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import torch_config  # noqa: F401
from .raster_cuda import raster_shade

_BIG = 1e30
# Largest (poses x pixels x faces) block the plain path evaluates at
# once; bounds its temporaries to a few hundred MB.
_BRUTE_BLOCK = 1 << 25


class RenderOutput(NamedTuple):
    color: torch.Tensor  # (N, H, W, 3) float32 in [0, 1]
    xyz: torch.Tensor  # (N, H, W, 3) camera-space position, 0 at background
    normal: torch.Tensor | None  # (N, H, W, 3) or None
    mask: torch.Tensor  # (N, H, W) bool foreground
    # faces dropped per (pose, tile); None: both paths here are exact
    overflow: torch.Tensor | None = None

    @property
    def depth(self) -> torch.Tensor:
        return self.xyz[..., 2]


class _Prepared(NamedTuple):
    """Per-pose raster inputs shared by the plain path and the kernel."""

    coeffs: torch.Tensor  # (N, F, 10) edge coefficients, col 9 = ok flag
    zinv: torch.Tensor  # (N, F, 3) per-vertex 1/z
    bbox: torch.Tensor  # (N, F, 4) [x0, x1, y0, y1] screen bbox
    faces: torch.Tensor  # (F, 3) int64
    vdata: torch.Tensor  # (N, V, D) packed per-vertex attributes
    c_col: int  # first color (or uv) column of vdata
    d_col: int  # diffuse column, -1 without light
    n_col: int  # first normal column, -1 without get_normal
    H: int
    W: int


def validate_faces(faces: torch.Tensor, n_vertices: int) -> None:
    """Raise ValueError unless every index in `faces` lies in [0, n_vertices).

    The kernel indexes vertex data with them, so every render checks
    them, but only once per tensor: a tensor that passed is marked with
    its vertex count and version counter (which any in-place write
    bumps), and a later check of the same tensor returns at once. The
    first check of a CUDA tensor reads its min and max back from the
    card; `make_mesh_tensors` makes it when it builds the mesh tensors,
    so the renders of the pipeline never do. Tensors made under
    torch.inference_mode carry no version counter and are checked on
    every call."""
    key = None if faces.is_inference() else (int(n_vertices), faces._version)
    if key is not None and getattr(faces, "_fp_valid_for", None) == key:
        return
    if faces.numel():
        lo, hi = torch.aminmax(faces)
        if int(lo) < 0 or int(hi) >= n_vertices:
            raise ValueError(f"face indices must lie in [0, {n_vertices})")
    if key is not None:
        faces._fp_valid_for = key


def _screen_vertices(pos, poses, K, crop_tf):
    """pos (V, 3), poses (N, 4, 4), K (3, 3), crop_tf (N, 3, 3) or None
    -> camera-space points (N, V, 3), screen coords (N, V, 2)."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    pts_cam = torch.einsum("nij,vj->nvi", R, pos) + t[:, None]
    z = torch.clamp(pts_cam[..., 2], min=1e-8)
    u = pts_cam[..., 0] * K[0, 0] / z + K[0, 2]
    v = pts_cam[..., 1] * K[1, 1] / z + K[1, 2]
    if crop_tf is not None:
        u = crop_tf[:, None, 0, 0] * u + crop_tf[:, None, 0, 2]
        v = crop_tf[:, None, 1, 1] * v + crop_tf[:, None, 1, 2]
    return pts_cam, torch.stack([u, v], dim=-1)


def _face_coeffs(xy_f, z_f, valid_f):
    """Sign-normalized barycentric + 1/z coefficients of (..., F) faces.

    xy_f (..., F, 3, 2), z_f (..., F, 3), valid_f (..., F) ->
    coeffs (..., F, 10) = [wa0,wb0,wc0, wa1,wb1,wc1, wa2,wb2,wc2, ok]
    with w_k(p) = wa_k*px + wb_k*py + wc_k already divided by the signed
    doubled area (inside <=> all w_k >= 0), and zinv (..., F, 3)."""
    x0, y0 = xy_f[..., 0, 0], xy_f[..., 0, 1]
    x1, y1 = xy_f[..., 1, 0], xy_f[..., 1, 1]
    x2, y2 = xy_f[..., 2, 0], xy_f[..., 2, 1]
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    small = torch.abs(area2) < 1e-12
    inv_area = torch.where(small, torch.zeros_like(area2), 1.0 / area2)
    ok = valid_f & (torch.abs(area2) > 1e-12)

    def edge(xa, ya, xb, yb):
        return (ya - yb) * inv_area, (xb - xa) * inv_area, (xa * yb - xb * ya) * inv_area

    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    zinv = torch.where(z_f > 1e-8, 1.0 / z_f, torch.zeros_like(z_f))
    coeffs = torch.stack(
        [a0, b0, c0, a1, b1, c1, a2, b2, c2, ok.to(torch.float32)], dim=-1
    )
    return coeffs, zinv


def _eval_faces(coeffs, zinv, px, py):
    """Edge-test faces at pixels (broadcast); perspective z, BIG outside."""
    w0 = px * coeffs[..., 0] + py * coeffs[..., 1] + coeffs[..., 2]
    w1 = px * coeffs[..., 3] + py * coeffs[..., 4] + coeffs[..., 5]
    w2 = px * coeffs[..., 6] + py * coeffs[..., 7] + coeffs[..., 8]
    # Subpixel epsilon keeps pixels exactly on shared edges covered by
    # both triangles (rounding can make both edge tests marginally
    # negative -> holes along face diagonals).
    eps = -1e-5
    inside = (w0 >= eps) & (w1 >= eps) & (w2 >= eps) & (coeffs[..., 9] > 0)
    zinv_sum = w0 * zinv[..., 0] + w1 * zinv[..., 1] + w2 * zinv[..., 2]
    hit = inside & (zinv_sum > 1e-12)
    return torch.where(hit, 1.0 / zinv_sum, torch.full_like(zinv_sum, _BIG))


def _rasterize_brute(coeffs, zinv, pix_u, pix_v, face_chunk):
    """Nearest covering face per pixel for a batch of poses.

    coeffs (N, F, 10), zinv (N, F, 3), pix_u/pix_v (P,) ->
    best_face (N, P) int64, covered (N, P) bool. Scans faces in
    ascending chunks; within a chunk the first minimum wins, across
    chunks only a strictly nearer face replaces: the lowest face index
    wins every exact tie."""
    N, F = coeffs.shape[:2]
    P = pix_u.shape[0]
    best_z = torch.full((N, P), _BIG, dtype=torch.float32, device=coeffs.device)
    best_face = torch.zeros((N, P), dtype=torch.int64, device=coeffs.device)
    px = pix_u[None, :, None]
    py = pix_v[None, :, None]
    for base in range(0, F, face_chunk):
        c = coeffs[:, None, base : base + face_chunk]
        zi = zinv[:, None, base : base + face_chunk]
        z = _eval_faces(c, zi, px, py)  # (N, P, C)
        z_min, idx = torch.min(z, dim=-1)  # first minimum on a tie
        better = z_min < best_z
        best_z = torch.where(better, z_min, best_z)
        best_face = torch.where(better, idx + base, best_face)
    return best_face, best_z < _BIG


def _sample_texture(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear texture sample; uv in [0, 1], texel centers at (i+0.5)/N,
    taps clamped to the border (nvdiffrast 'linear')."""
    Ht, Wt = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * Wt - 0.5
    y = uv[..., 1] * Ht - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    def tap(yi, xi):
        return tex[torch.clamp(yi, 0, Ht - 1), torch.clamp(xi, 0, Wt - 1)]

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


_DEFAULT_LIGHT: dict = {}


def _default_light(dev) -> torch.Tensor:
    """The default light direction (0, 0, 1) on `dev`, made once per
    device: a render then copies nothing from the host, which also lets
    a CUDA graph capture it. Made outside inference mode so that an
    autograd graph may save it."""
    light = _DEFAULT_LIGHT.get(dev)
    if light is None:
        with torch.inference_mode(False):
            light = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev)
        _DEFAULT_LIGHT[dev] = light
    return light


def _prepare(
    pos, faces, poses, K, out_hw, crop_tf, vertex_color, uv, vnormals,
    use_light, get_normal, light_dir, cull_backfaces,
) -> _Prepared:
    H, W = out_hw
    dev = poses.device
    pos = pos.to(torch.float32)
    poses = poses.to(torch.float32)
    K = K.to(torch.float32)
    faces = faces.to(torch.int64).contiguous()
    if crop_tf is not None:
        crop_tf = crop_tf.to(torch.float32)
    if (use_light or get_normal) and vnormals is None:
        raise ValueError("vnormals required when lighting/normals requested")
    if light_dir is None:
        light_dir = _default_light(dev)
    else:
        light_dir = torch.as_tensor(light_dir, dtype=torch.float32, device=dev)

    pts_cam, xy = _screen_vertices(pos, poses, K, crop_tf)
    xy_f = xy[:, faces]  # (N, F, 3, 2)
    z_f = pts_cam[:, faces, 2]  # (N, F, 3)
    valid_f = torch.all(z_f > 1e-4, dim=-1)
    if cull_backfaces:
        p_f = pts_cam[:, faces]  # (N, F, 3, 3)
        p0 = p_f[:, :, 0]
        fn = torch.linalg.cross(p_f[:, :, 1] - p0, p_f[:, :, 2] - p0, dim=-1)
        valid_f = valid_f & (torch.sum(fn * p0, dim=-1) < 0)
    coeffs, zinv = _face_coeffs(xy_f, z_f, valid_f)
    bbox = torch.stack(
        [
            torch.amin(xy_f[..., 0], dim=-1),
            torch.amax(xy_f[..., 0], dim=-1),
            torch.amin(xy_f[..., 1], dim=-1),
            torch.amax(xy_f[..., 1], dim=-1),
        ],
        dim=-1,
    )

    # Packed per-vertex attributes, shared by both paths:
    # [u, v | x, y, z cam | color or uv | diffuse (use_light) | normal].
    N, V = pts_cam.shape[:2]
    cols = [xy, pts_cam]
    c_col = d_col = n_col = -1
    off = 5
    if uv is not None:
        cols.append(uv.to(torch.float32)[None].expand(N, V, 2))
        c_col, off = off, off + 2
    elif vertex_color is not None:
        cols.append(vertex_color.to(torch.float32)[None].expand(N, V, 3))
        c_col, off = off, off + 3
    if use_light or get_normal:
        vn_cam = torch.einsum("nij,vj->nvi", poses[:, :3, :3], vnormals.to(torch.float32))
        if use_light:
            vn_n = vn_cam / torch.clamp(
                torch.linalg.norm(vn_cam, dim=-1, keepdim=True), min=1e-12
            )
            diff = torch.clamp(torch.sum(vn_n * (-light_dir), dim=-1), 0.0, 1.0)
            cols.append(diff[..., None])
            d_col, off = off, off + 1
        if get_normal:
            cols.append(vn_cam)
            n_col = off
    vdata = torch.cat(cols, dim=-1).contiguous()
    return _Prepared(coeffs, zinv, bbox, faces, vdata, c_col, d_col, n_col, H, W)


def _interpolate(prep: _Prepared, best_face, pix_u, pix_v):
    """Perspective-correct attributes of the winning faces.

    best_face (N, P) -> (N, P, D). The screen barycentrics are rebuilt
    from the winner's vertices, as the reference brute path does."""
    N, V, D = prep.vdata.shape
    tri = prep.faces[best_face]  # (N, P, 3)
    flat = prep.vdata.reshape(N * V, D)
    rows = (torch.arange(N, device=tri.device) * V)[:, None, None] + tri
    va, vb, vc = (flat[rows[..., k]] for k in range(3))  # (N, P, D)

    pu = pix_u[None]
    pv = pix_v[None]
    area2 = (vb[..., 0] - va[..., 0]) * (vc[..., 1] - va[..., 1]) - (
        vc[..., 0] - va[..., 0]
    ) * (vb[..., 1] - va[..., 1])
    inv_a = torch.where(torch.abs(area2) < 1e-12, torch.zeros_like(area2), 1.0 / area2)
    w0 = ((vb[..., 0] - pu) * (vc[..., 1] - pv) - (vc[..., 0] - pu) * (vb[..., 1] - pv)) * inv_a
    w1 = ((vc[..., 0] - pu) * (va[..., 1] - pv) - (va[..., 0] - pu) * (vc[..., 1] - pv)) * inv_a
    w2 = 1.0 - w0 - w1
    zs = torch.stack([va[..., 4], vb[..., 4], vc[..., 4]], dim=-1)
    zi = torch.where(zs > 1e-8, 1.0 / zs, torch.zeros_like(zs))
    zsum = w0 * zi[..., 0] + w1 * zi[..., 1] + w2 * zi[..., 2]
    zsum = torch.clamp(zsum, min=1e-12)
    c0 = (w0 * zi[..., 0] / zsum)[..., None]
    c1 = (w1 * zi[..., 1] / zsum)[..., None]
    c2 = 1.0 - c0 - c1
    return va * c0 + vb * c1 + vc * c2


def _finalize(prep: _Prepared, interp, m, tex, w_ambient, w_diffuse):
    """(N, P, D) winner attributes + coverage -> image tensors."""
    N = interp.shape[0]
    H, W = prep.H, prep.W
    mm = m[..., None]
    zero3 = torch.zeros_like(interp[..., :3])
    xyz = torch.where(mm, interp[..., 2:5], zero3)
    if tex is not None:
        color = _sample_texture(tex, interp[..., prep.c_col : prep.c_col + 2])
    elif prep.c_col >= 0:
        color = interp[..., prep.c_col : prep.c_col + 3]
    else:
        color = torch.full_like(zero3, 0.5)
    if prep.d_col >= 0:
        diff = interp[..., prep.d_col : prep.d_col + 1]
        color = color * w_ambient + diff * color * w_diffuse
    normal = None
    if prep.n_col >= 0:
        n_pix = interp[..., prep.n_col : prep.n_col + 3]
        n_pix = n_pix / torch.clamp(torch.linalg.norm(n_pix, dim=-1, keepdim=True), min=1e-12)
        normal = torch.where(mm, n_pix, zero3).reshape(N, H, W, 3)
    color = torch.where(mm, torch.clamp(color, 0.0, 1.0), zero3)
    return (
        color.reshape(N, H, W, 3),
        xyz.reshape(N, H, W, 3),
        normal,
        m.reshape(N, H, W),
    )


def _pixel_grid(H, W, device):
    ii, jj = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return jj.reshape(-1), ii.reshape(-1)


def shade_brute(prep: _Prepared, tex, w_ambient, w_diffuse, face_chunk=512):
    """Plain version of the tile kernel: brute raster + interpolation +
    shading, in pose blocks that bound the temporaries."""
    N = prep.coeffs.shape[0]
    P = prep.H * prep.W
    pix_u, pix_v = _pixel_grid(prep.H, prep.W, prep.coeffs.device)
    chunk = max(1, min(face_chunk, prep.coeffs.shape[1]))
    nb = max(1, min(N, _BRUTE_BLOCK // max(P * chunk, 1)))
    outs = []
    for s in range(0, N, nb):
        sub = prep._replace(
            coeffs=prep.coeffs[s : s + nb],
            zinv=prep.zinv[s : s + nb],
            vdata=prep.vdata[s : s + nb],
        )
        best_face, covered = _rasterize_brute(sub.coeffs, sub.zinv, pix_u, pix_v, chunk)
        interp = _interpolate(sub, best_face, pix_u, pix_v)
        outs.append(_finalize(sub, interp, covered, tex, w_ambient, w_diffuse))
    color, xyz, normal, mask = (
        None if o[0] is None else torch.cat(o) for o in zip(*outs)
    )
    return color, xyz, normal, mask


def _render(kind, pos, faces, poses, K, *, out_hw, crop_tf=None, vertex_color=None,
            uv=None, tex=None, vnormals=None, use_light=True, get_normal=False,
            light_dir=None, w_ambient=0.8, w_diffuse=0.5, face_chunk=512,
            cull_backfaces=False) -> RenderOutput:
    if uv is not None and tex is None:
        raise ValueError("uv given without tex")
    validate_faces(faces, pos.shape[0])
    prep = _prepare(
        pos, faces, poses, K, out_hw, crop_tf, vertex_color, uv, vnormals,
        use_light, get_normal, light_dir, cull_backfaces,
    )
    # as in the reference, a texture is sampled only through uv
    tex = tex.to(torch.float32) if uv is not None else None
    if kind == "plain":
        out = shade_brute(prep, tex, w_ambient, w_diffuse, face_chunk)
    else:  # CUDA: the kernel; CPU: shade_brute; other devices raise
        out = raster_shade(prep, tex, w_ambient, w_diffuse)
    color, xyz, normal, mask = out
    return RenderOutput(color=color, xyz=xyz, normal=normal, mask=mask)


def render_mesh(pos, faces, poses, K, **kw) -> RenderOutput:
    """Render N pose hypotheses of one mesh.

    pos (V, 3), faces (F, 3), poses (N, 4, 4) object-in-camera (OpenCV),
    K (3, 3); keywords as the reference's render_mesh: out_hw, crop_tf
    (N, 3, 3) full-image -> crop pixels (None renders the full image),
    vertex_color (V, 3) or uv (V, 2) + tex (Ht, Wt, 3), vnormals,
    use_light (Gouraud: color * (w_ambient + diffuse * w_diffuse)),
    get_normal, cull_backfaces (exact for closed, outward-wound meshes).

    CUDA tensors run the tile kernel (ops/raster_cuda.py); CPU tensors
    the plain brute path. Face indices outside [0, V) raise ValueError;
    they are checked once per faces tensor (`validate_faces`), so faces
    from `make_mesh_tensors` are not read back here."""
    return _render("dispatch", pos, faces, poses, K, **kw)


def render_mesh_brute(pos, faces, poses, K, **kw) -> RenderOutput:
    """The plain version of render_mesh on any device (same arguments)."""
    return _render("plain", pos, faces, poses, K, **kw)
