"""Texture baking for reconstructed meshes.

Port of foundationpose_tpu/nerf/texture.py (which replaces
nerf_runner.py:1121-1232: xatlas unwrap + pyrender depth test +
rayColorToTextureImageCUDA splat). The host numpy is the JAX package's;
the visibility depth maps come from the port's `render_mesh`, which runs
K1 (csrc/raster.cu) on a CUDA device, all views in one call.

* UV atlas: per-triangle packing, two inset triangles per texture cell,
  so every face gets a private patch.
* View selection: top-`top_views` visible views per face by incidence
  angle (the reference's _CHOOSE_TOP_N = 4, nerf_runner.py:1174-1180),
  blended with incidence-cosine weights (`uniform_blend=True` gives the
  reference's uniform average).
* Color transfer: every texel maps through barycentrics to a surface
  point, projects into each chosen view and samples the training image
  bilinearly.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..meshio import TriMesh

from ..ops.rasterizer import render_mesh

logger = logging.getLogger(__name__)


def make_triangle_atlas(n_faces: int, tex_res: int):
    """Per-face UVs in a cell grid. Returns (uv (3F, 2) in [0,1],
    face_uv_idx (F, 3), cell geometry for texel mapping)."""
    n_cells = (n_faces + 1) // 2
    grid = int(np.ceil(np.sqrt(n_cells)))
    cell = tex_res // grid
    margin = max(1.0, cell * 0.12)

    uvs = np.zeros((n_faces, 3, 2), np.float64)
    for k in range(2):  # lower-left (k=0) and upper-right (k=1) triangles
        ids = np.arange(k, n_faces, 2)
        cells = ids // 2
        cx = (cells % grid) * cell
        cy = (cells // grid) * cell
        if k == 0:
            corners = np.array(
                [[margin, margin], [cell - margin, margin], [margin, cell - margin]]
            )
        else:
            corners = np.array(
                [
                    [cell - margin, cell - margin],
                    [margin, cell - margin],
                    [cell - margin, margin],
                ]
            )
        uvs[ids] = (
            np.stack([cx, cy], axis=-1)[:, None, :] + corners[None]
        )
    uvs /= tex_res
    return uvs.reshape(-1, 2), np.arange(3 * n_faces).reshape(-1, 3)


def bake_texture(
    mesh: TriMesh,
    rgbs: np.ndarray,  # (V_views, H, W, 3) uint8 raw training images
    depths: np.ndarray,  # (V_views, H, W) meters (sensor or rendered)
    cam_in_obs: np.ndarray,  # (V_views, 4, 4) meters, CV convention
    K: np.ndarray,
    tex_res: int = 1024,
    depth_tol: float = 0.01,
    top_views: int = 4,
    uniform_blend: bool = False,
    device="cuda",
) -> TriMesh:
    """Returns a copy of `mesh` with texture + per-vertex-split UVs.

    `uniform_blend=True` reproduces the reference's blend exactly
    (uniform average of the visible top-4 views); the default weights
    those same views by incidence cosine — a documented deviation that
    de-emphasizes grazing views (see the blend comment below). The
    depth maps are rendered on `device`.
    """
    V = mesh.vertices
    F = mesh.faces
    n_views = len(rgbs)
    H, W = rgbs.shape[1:3]

    # Render the mesh's own depth in every view for the visibility test.
    ob_in_cams = np.linalg.inv(cam_in_obs)

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    rend = render_mesh(
        T(V),
        torch.as_tensor(F.astype(np.int64), device=device),
        T(ob_in_cams),
        T(K),
        out_hw=(H, W),
        vertex_color=torch.ones((len(V), 3), dtype=torch.float32, device=device),
        use_light=False,
    )
    depth_maps = rend.depth.cpu().numpy()  # (V_views, H, W)

    # --- best view per face
    centroids = V[F].mean(axis=1)  # (F, 3)
    fnormals = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    fn = fnormals / np.maximum(np.linalg.norm(fnormals, axis=-1, keepdims=True), 1e-12)

    c_cam = (
        np.einsum("vij,fj->vfi", ob_in_cams[:, :3, :3], centroids)
        + ob_in_cams[:, None, :3, 3]
    )  # (views, F, 3)
    n_cam = np.einsum("vij,fj->vfi", ob_in_cams[:, :3, :3], fn)
    view_dir = c_cam / np.maximum(np.linalg.norm(c_cam, axis=-1, keepdims=True), 1e-12)
    cos = -np.sum(n_cam * view_dir, axis=-1)  # (views, F) facing score

    u = c_cam[..., 0] / c_cam[..., 2] * K[0, 0] + K[0, 2]
    v = c_cam[..., 1] / c_cam[..., 2] * K[1, 1] + K[1, 2]
    ui = np.clip(np.round(u).astype(int), 0, W - 1)
    vi = np.clip(np.round(v).astype(int), 0, H - 1)
    dm = depth_maps[np.arange(n_views)[:, None], vi, ui]  # (views, F)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (c_cam[..., 2] > 1e-4)
    visible = inb & (np.abs(dm - c_cam[..., 2]) < depth_tol) & (cos > 0)
    score = np.where(visible, cos, -1.0)
    n_blend = max(1, min(top_views, n_views))
    # Top-N views per face by incidence cosine, descending. The VIEW
    # SELECTION matches the reference (per-triangle top-4 by angle,
    # nerf_runner.py:1174-1180); the BLEND deliberately deviates: the
    # reference averages its top-4 with uniform 0/1 weights normalized
    # by count, while we weight by the incidence cosine so grazing
    # views contribute less than frontal ones (less smearing at
    # silhouettes). Pass uniform_blend=True for the reference's
    # uniform average.
    top_idx = np.argsort(-score, axis=0)[:n_blend]  # (N, F)
    top_w = np.maximum(
        score[top_idx, np.arange(len(F))[None]], 0.0
    )  # (N, F) cosine weights; 0 for invisible ranks
    if uniform_blend:
        top_w = (top_w > 0).astype(top_w.dtype)
    has_view = top_w[0] > 0

    # --- atlas
    uv, face_uv_idx = make_triangle_atlas(len(F), tex_res)
    n_cells = (len(F) + 1) // 2
    grid = int(np.ceil(np.sqrt(n_cells)))
    cell = tex_res // grid

    # --- texel -> color: iterate texels of one cell, all faces at once.
    tex = np.zeros((tex_res, tex_res, 3), np.float32)
    wsum = np.zeros((tex_res, tex_res, 1), np.float32)

    tri_uv_px = uv[face_uv_idx] * tex_res  # (F, 3, 2)
    rgbs_f = rgbs.astype(np.float32)

    # Barycentric sample grid per face patch (dense enough to cover the
    # inset triangle at cell resolution).
    n_s = max(2, cell)
    bi, bj = np.meshgrid(np.arange(n_s), np.arange(n_s), indexing="ij")
    b0 = (bi + 0.34) / n_s
    b1 = (bj + 0.33) / n_s
    keep = (b0 + b1) < 1.0
    b0 = b0[keep]
    b1 = b1[keep]
    b2 = 1.0 - b0 - b1  # (T,)
    T = len(b0)

    # World points per (face, texel-sample).
    p = (
        V[F[:, 0]][:, None] * b0[None, :, None]
        + V[F[:, 1]][:, None] * b1[None, :, None]
        + V[F[:, 2]][:, None] * b2[None, :, None]
    )  # (F, T, 3)

    def sample_rank(view_of_face):
        """Bilinear colors of every (face, texel-sample) in one view
        per face. view_of_face: (F,) int."""
        ob2cam = ob_in_cams[view_of_face]  # (F, 4, 4)
        p_cam = (
            np.einsum("fij,ftj->fti", ob2cam[:, :3, :3], p)
            + ob2cam[:, None, :3, 3]
        )
        pu = p_cam[..., 0] / p_cam[..., 2] * K[0, 0] + K[0, 2]
        pv = p_cam[..., 1] / p_cam[..., 2] * K[1, 1] + K[1, 2]
        pu = np.clip(pu, 0, W - 1.001)
        pv = np.clip(pv, 0, H - 1.001)
        u0 = np.floor(pu).astype(int)
        v0 = np.floor(pv).astype(int)
        fu = (pu - u0)[..., None]
        fv = (pv - v0)[..., None]
        vw = view_of_face[:, None]

        def tap(vv, uu):
            return rgbs_f[np.broadcast_to(vw, vv.shape), vv, uu]

        return (
            tap(v0, u0) * (1 - fu) * (1 - fv)
            + tap(v0, np.minimum(u0 + 1, W - 1)) * fu * (1 - fv)
            + tap(np.minimum(v0 + 1, H - 1), u0) * (1 - fu) * fv
            + tap(np.minimum(v0 + 1, H - 1), np.minimum(u0 + 1, W - 1))
            * fu
            * fv
        )  # (F, T, 3)

    # Angle-weighted blend over the top-N visible views of each face.
    col = np.zeros((len(F), T, 3), np.float32)
    wtot = np.zeros((len(F), 1, 1), np.float32)
    for n in range(n_blend):
        w = top_w[n][:, None, None]
        if not (w > 0).any():
            break
        col += sample_rank(top_idx[n]) * w
        wtot += w
    col /= np.maximum(wtot, 1e-12)
    col[~has_view] = 128.0

    # Texel positions in the atlas for each (face, sample).
    tx = (
        tri_uv_px[:, 0, 0][:, None] * b0[None]
        + tri_uv_px[:, 1, 0][:, None] * b1[None]
        + tri_uv_px[:, 2, 0][:, None] * b2[None]
    )
    ty = (
        tri_uv_px[:, 0, 1][:, None] * b0[None]
        + tri_uv_px[:, 1, 1][:, None] * b1[None]
        + tri_uv_px[:, 2, 1][:, None] * b2[None]
    )
    txi = np.clip(np.round(tx).astype(int), 0, tex_res - 1).reshape(-1)
    tyi = np.clip(np.round(ty).astype(int), 0, tex_res - 1).reshape(-1)
    np.add.at(tex, (tyi, txi), col.reshape(-1, 3))
    np.add.at(wsum, (tyi, txi), 1.0)
    tex = tex / np.maximum(wsum, 1.0)

    # Nearest-fill unwritten texels inside patches (texture_map_interpolation
    # equivalent, Utils.py:886-900) — cheap dilation passes.
    written = wsum[..., 0] > 0
    for _ in range(3):
        if written.all():
            break
        import scipy.ndimage as ndi

        nearest = ndi.grey_dilation(written.astype(np.uint8), size=3) > 0
        fill = nearest & ~written
        if not fill.any():
            break
        blur = ndi.uniform_filter(tex * written[..., None], size=3, axes=(0, 1))
        cnt = ndi.uniform_filter(written.astype(np.float32), size=3)
        tex[fill] = (blur[fill] / np.maximum(cnt[fill, None], 1e-6))
        written = nearest

    # TriMesh carries OBJ-convention UVs (v up); the atlas rows are v-down,
    # matching the flip applied at mesh_tensors build (Utils.py:117).
    uv_obj = uv.astype(np.float32).copy()
    uv_obj[:, 1] = 1.0 - uv_obj[:, 1]
    out = TriMesh(
        vertices=V[F].reshape(-1, 3),
        faces=face_uv_idx.astype(np.int64),
        uv=uv_obj,
        texture=np.clip(tex, 0, 255).astype(np.uint8),
    )
    logger.info(
        "baked texture %dx%d, %d faces, %d with views", tex_res, tex_res, len(F),
        int(has_view.sum()),
    )
    return out
