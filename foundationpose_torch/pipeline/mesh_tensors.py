"""Device-resident mesh tensors (port of foundationpose_tpu/pipeline/
mesh_tensors.py, the reference's make_mesh_tensors, Utils.py:104-130)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import torch_config  # noqa: F401
from ..meshio import TriMesh
from ..ops.rasterizer import validate_faces


class MeshTensors(NamedTuple):
    pos: torch.Tensor  # (V, 3) f32
    faces: torch.Tensor  # (F, 3) int64
    vnormals: torch.Tensor  # (V, 3) f32
    vertex_color: torch.Tensor | None  # (V, 3) f32 in [0, 1], or None
    uv: torch.Tensor | None  # (V, 2) f32, or None
    tex: torch.Tensor | None  # (Ht, Wt, 3) f32 in [0, 1], or None


def morton_sort_faces(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Reorder faces along a Morton (Z-order) curve of their centroids.

    Spatially coherent face order makes 128-face chunks project to
    compact screen patches under any pose, which lets the tile
    rasterizer (csrc/raster.cu) skip chunks per tile. Rendering does not
    depend on face order except for exact-depth ties (coplanar
    duplicates). Returns the permuted (F, 3) array."""
    c = vertices[faces].mean(axis=1)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.minimum(((c - lo) / span * 1023.0).astype(np.uint64), 1023)

    def spread(x):  # interleave 10 bits with 2-bit gaps
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return faces[np.argsort(code, kind="stable")]


def make_mesh_tensors(
    mesh: TriMesh, max_tex_size: int | None = None, device="cpu"
) -> MeshTensors:
    """Upload a mesh: texture V-flip (uv[:, 1] = 1 - v), gray vertex
    colors when the mesh has neither texture nor colors, Morton-sorted
    faces, checked here once (`validate_faces`) so that renders of them
    read nothing back from the card."""
    uv = tex = vertex_color = None
    if mesh.has_texture:
        img = mesh.texture
        if max_tex_size is not None and max(img.shape[:2]) > max_tex_size:
            from PIL import Image

            scale = max_tex_size / max(img.shape[:2])
            new_wh = (int(img.shape[1] * scale), int(img.shape[0] * scale))
            img = np.asarray(Image.fromarray(img).resize(new_wh))
        tex = torch.as_tensor(np.asarray(img, np.float32) / 255.0, device=device)
        uv_np = np.asarray(mesh.uv, dtype=np.float32).copy()
        uv_np[:, 1] = 1.0 - uv_np[:, 1]
        uv = torch.as_tensor(uv_np, device=device)
    else:
        colors = mesh.vertex_colors
        if colors is None:
            colors = np.full((len(mesh.vertices), 3), 128, dtype=np.uint8)
        vertex_color = torch.as_tensor(
            np.asarray(colors[:, :3], np.float32) / 255.0, device=device
        )
    faces_np = morton_sort_faces(
        np.asarray(mesh.vertices, np.float64), np.asarray(mesh.faces, np.int64)
    )
    faces = torch.as_tensor(faces_np, dtype=torch.int64, device=device)
    validate_faces(faces, len(mesh.vertices))
    return MeshTensors(
        pos=torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=device),
        faces=faces,
        vnormals=torch.as_tensor(np.asarray(mesh.vertex_normals, np.float32), device=device),
        vertex_color=vertex_color,
        uv=uv,
        tex=tex,
    )
