"""Minimal triangle-mesh container + OBJ/PLY I/O (host-side numpy).

A copy of the helpers of foundationpose_tpu/meshio.py that this package
uses (the mesh container, loaders, OBJ and PLY export, box, voxel
downsample, diameter, texture sampling, decimation, flat colors), so that the port imports
nothing of the JAX package. They replace the reference's trimesh/open3d
usage (estimater.py:44-78, Utils.py:104-130).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (F, 3) int64
    vertex_colors: np.ndarray | None = None  # (V, 3) uint8
    uv: np.ndarray | None = None  # (V, 2) float32, per-vertex
    texture: np.ndarray | None = None  # (Ht, Wt, 3) uint8
    _vertex_normals: np.ndarray | None = None

    def copy(self) -> "TriMesh":
        return TriMesh(
            vertices=self.vertices.copy(),
            faces=self.faces.copy(),
            vertex_colors=None if self.vertex_colors is None else self.vertex_colors.copy(),
            uv=None if self.uv is None else self.uv.copy(),
            texture=None if self.texture is None else self.texture.copy(),
        )

    @property
    def vertex_normals(self) -> np.ndarray:
        if self._vertex_normals is None:
            self._vertex_normals = compute_vertex_normals(self.vertices, self.faces)
        return self._vertex_normals

    @property
    def has_texture(self) -> bool:
        return self.texture is not None and self.uv is not None

    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    def export(self, path: str) -> None:
        export_obj(self, path)


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (matches trimesh's default weighting)."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted face normals
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norms = np.linalg.norm(vn, axis=-1, keepdims=True)
    norms[norms < 1e-12] = 1.0
    return vn / norms


def load_mesh(path: str) -> TriMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_obj(path: str) -> TriMesh:
    """Wavefront OBJ with optional per-face-vertex UVs and an MTL texture.

    Faces with v/vt indices are re-indexed so UVs become per-vertex
    (vertices referenced with conflicting UVs are duplicated), matching
    how the rasterizer consumes them.
    """
    verts: list[list[float]] = []
    uvs: list[list[float]] = []
    colors: list[list[float]] = []
    face_v: list[tuple[int, int, int]] = []
    face_vt: list[tuple[int, int, int] | None] = []
    mtl_file = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:  # vertex color extension
                    colors.append([float(x) for x in parts[4:7]])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("f "):
                parts = line.split()[1:]
                if len(parts) < 3:
                    continue
                idx = []
                tidx = []
                for p in parts:
                    sub = p.split("/")
                    idx.append(int(sub[0]))
                    if len(sub) > 1 and sub[1] != "":
                        tidx.append(int(sub[1]))
                # fan-triangulate polygons
                for k in range(1, len(idx) - 1):
                    face_v.append((idx[0], idx[k], idx[k + 1]))
                    if len(tidx) == len(idx):
                        face_vt.append((tidx[0], tidx[k], tidx[k + 1]))
                    else:
                        face_vt.append(None)
            elif line.startswith("mtllib"):
                mtl_file = line.split(None, 1)[1].strip()

    verts_np = np.asarray(verts, dtype=np.float64)
    nv = len(verts_np)

    def fix(i: int) -> int:
        return i - 1 if i > 0 else nv + i

    faces_np = np.array(
        [[fix(a), fix(b), fix(c)] for a, b, c in face_v], dtype=np.int64
    )

    texture = None
    if mtl_file is not None:
        tex_path = _texture_from_mtl(os.path.join(os.path.dirname(path), mtl_file))
        if tex_path is not None:
            texture = _load_image(tex_path)

    uv_np = None
    if uvs and any(t is not None for t in face_vt) and texture is not None:
        # Re-index to per-vertex UV, splitting vertices on UV seams.
        uvs_np = np.asarray(uvs, dtype=np.float64)
        nt = len(uvs_np)

        def fixt(i: int) -> int:
            return i - 1 if i > 0 else nt + i

        key_to_new: dict[tuple[int, int], int] = {}
        new_verts: list[int] = []
        new_uv: list[int] = []
        new_faces = np.zeros_like(faces_np)
        for fi, (fv, ft) in enumerate(zip(face_v, face_vt)):
            if ft is None:
                ft = fv  # degenerate; reuse vertex index as uv index
            for k in range(3):
                key = (fix(fv[k]), fixt(ft[k]))
                if key not in key_to_new:
                    key_to_new[key] = len(new_verts)
                    new_verts.append(key[0])
                    new_uv.append(key[1])
                new_faces[fi, k] = key_to_new[key]
        verts_out = verts_np[np.array(new_verts)]
        uv_np = uvs_np[np.array(new_uv)].astype(np.float32)
        colors_np = None
        if colors:
            colors_arr = (np.asarray(colors) * 255).astype(np.uint8)
            colors_np = colors_arr[np.array(new_verts)]
        return TriMesh(
            vertices=verts_out,
            faces=new_faces,
            vertex_colors=colors_np,
            uv=uv_np,
            texture=texture,
        )

    colors_np = (np.asarray(colors) * 255).astype(np.uint8) if colors else None
    return TriMesh(vertices=verts_np, faces=faces_np, vertex_colors=colors_np)


def _texture_from_mtl(mtl_path: str) -> str | None:
    if not os.path.exists(mtl_path):
        return None
    with open(mtl_path, "r", errors="replace") as f:
        for line in f:
            if line.strip().startswith("map_Kd"):
                tex = line.split(None, 1)[1].strip()
                cand = os.path.join(os.path.dirname(mtl_path), tex)
                if os.path.exists(cand):
                    return cand
    return None


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def load_ply(path: str) -> TriMesh:
    """PLY loader (ascii + binary little/big endian), vertices/colors/uv/faces."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    cur_props: list[tuple[str, str]] = []
    tex_file = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "comment":
            if len(parts) >= 3 and parts[1] == "TextureFile":
                tex_file = parts[2]
        elif parts[0] == "element":
            cur_props = []
            elements.append((parts[1], int(parts[2]), cur_props))
        elif parts[0] == "property":
            if parts[1] == "list":
                cur_props.append((" ".join(parts[2:4]), parts[4]))
            else:
                cur_props.append((parts[1], parts[2]))

    np_types = {
        "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
        "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
        "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
        "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    }

    verts = faces = colors = uv = None
    if fmt == "ascii":
        tokens = body.decode("ascii", errors="replace").split("\n")
        li = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                while li < len(tokens) and not tokens[li].strip():
                    li += 1
                rows.append(tokens[li].split())
                li += 1
            if name == "vertex":
                names = [p[1] for p in props]
                arr = np.asarray(rows, dtype=np.float64)
                verts, colors, uv = _extract_vertex_props(arr, names)
            elif name == "face":
                faces = np.asarray([[r[1], r[2], r[3]] for r in rows], dtype=np.int64)
    else:
        endian = "<" if "little" in fmt else ">"
        off = 0
        for name, count, props in elements:
            is_list = any(" " in p[0] for p in props)
            if not is_list:
                dt = np.dtype([(p[1], endian + np_types[p[0]]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                if name == "vertex":
                    names = [p[1] for p in props]
                    cols = np.stack(
                        [arr[n].astype(np.float64) for n in names], axis=-1
                    )
                    verts, colors, uv = _extract_vertex_props(cols, names)
            else:
                # face element: list prop rows, parse sequentially
                rows = []
                for _ in range(count):
                    row_vals = []
                    for ptype, _pname in props:
                        if " " in ptype:
                            cnt_t, item_t = ptype.split()
                            cnt_dt = np.dtype(endian + np_types[cnt_t])
                            n_items = int(
                                np.frombuffer(body, cnt_dt, 1, off)[0]
                            )
                            off += cnt_dt.itemsize
                            item_dt = np.dtype(endian + np_types[item_t])
                            vals = np.frombuffer(body, item_dt, n_items, off)
                            off += item_dt.itemsize * n_items
                            row_vals.append(vals)
                        else:
                            dt = np.dtype(endian + np_types[ptype])
                            row_vals.append(np.frombuffer(body, dt, 1, off))
                            off += dt.itemsize
                    rows.append(row_vals)
                if name == "face":
                    tri = []
                    for row in rows:
                        idx = row[0]
                        for k in range(1, len(idx) - 1):
                            tri.append([idx[0], idx[k], idx[k + 1]])
                    faces = np.asarray(tri, dtype=np.int64)

    texture = None
    if tex_file is not None:
        cand = os.path.join(os.path.dirname(path), tex_file)
        if os.path.exists(cand):
            texture = _load_image(cand)
    if texture is None:
        uv = None
    if faces is None:
        faces = np.zeros((0, 3), dtype=np.int64)
    return TriMesh(
        vertices=verts, faces=faces, vertex_colors=colors, uv=uv, texture=texture
    )


def _extract_vertex_props(arr: np.ndarray, names: list[str]):
    def col(n):
        return arr[:, names.index(n)] if n in names else None

    verts = np.stack([col("x"), col("y"), col("z")], axis=-1)
    colors = None
    if "red" in names:
        colors = np.stack([col("red"), col("green"), col("blue")], axis=-1).astype(
            np.uint8
        )
    uv = None
    if "texture_u" in names:
        uv = np.stack([col("texture_u"), col("texture_v")], axis=-1).astype(np.float32)
    elif "s" in names and "t" in names:
        uv = np.stack([col("s"), col("t")], axis=-1).astype(np.float32)
    return verts, colors, uv


def export_obj(mesh: TriMesh, path: str) -> None:
    lines = []
    has_color = mesh.vertex_colors is not None
    for i, v in enumerate(mesh.vertices):
        if has_color:
            c = mesh.vertex_colors[i] / 255.0
            lines.append(
                f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}"
            )
        else:
            lines.append(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}")
    if mesh.uv is not None:
        for t in mesh.uv:
            lines.append(f"vt {t[0]:.8f} {t[1]:.8f}")
        for f in mesh.faces:
            lines.append(f"f {f[0]+1}/{f[0]+1} {f[1]+1}/{f[1]+1} {f[2]+1}/{f[2]+1}")
    else:
        for f in mesh.faces:
            lines.append(f"f {f[0]+1} {f[1]+1} {f[2]+1}")
    with open(path, "w") as fo:
        fo.write("\n".join(lines) + "\n")
    if mesh.texture is not None and mesh.uv is not None:
        from PIL import Image

        base = os.path.splitext(path)[0]
        Image.fromarray(mesh.texture).save(base + ".png")
        mtl = base + ".mtl"
        with open(mtl, "w") as fo:
            fo.write(
                f"newmtl material_0\nmap_Kd {os.path.basename(base)}.png\n"
            )
        with open(path, "r") as fi:
            content = fi.read()
        with open(path, "w") as fo:
            fo.write(f"mtllib {os.path.basename(mtl)}\nusemtl material_0\n" + content)


def export_ply(mesh: TriMesh, path: str) -> None:
    """ASCII PLY with optional vertex colors (BOP model format)."""
    has_color = mesh.vertex_colors is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(mesh.vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(mesh.faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(mesh.vertices):
            line = f"{v[0]:.8f} {v[1]:.8f} {v[2]:.8f}"
            if has_color:
                c = mesh.vertex_colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")
        for face in mesh.faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def make_box(extents: np.ndarray) -> TriMesh:
    """Axis-aligned box mesh centered at origin (placeholder-object helper,
    used like the reference's trimesh box at run_ycb_video.py:87)."""
    e = np.asarray(extents, dtype=np.float64) / 2.0
    corners = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        dtype=np.float64,
    ) * e
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom (z-)
            [4, 5, 6], [4, 6, 7],  # top (z+)
            [0, 1, 5], [0, 5, 4],  # y-
            [2, 3, 7], [2, 7, 6],  # y+
            [1, 2, 6], [1, 6, 5],  # x+
            [3, 0, 4], [3, 4, 7],  # x-
        ],
        dtype=np.int64,
    )
    return TriMesh(vertices=corners, faces=faces)


def voxel_downsample(
    points: np.ndarray, voxel_size: float, normals: np.ndarray | None = None
):
    """Average points (and normals) per occupied voxel — open3d
    voxel_down_sample semantics (estimater.py:60)."""
    mins = points.min(axis=0)
    idx = np.floor((points - mins) / voxel_size).astype(np.int64)
    key = (idx[:, 0] << 42) + (idx[:, 1] << 21) + idx[:, 2]
    order = np.argsort(key)
    key_sorted = key[order]
    uniq, start = np.unique(key_sorted, return_index=True)
    counts = np.diff(np.append(start, len(key_sorted)))
    sums = np.add.reduceat(points[order], start, axis=0)
    pts_out = sums / counts[:, None]
    if normals is not None:
        nsum = np.add.reduceat(normals[order], start, axis=0)
        nn = np.linalg.norm(nsum, axis=-1, keepdims=True)
        nn[nn < 1e-12] = 1.0
        return pts_out, nsum / nn
    return pts_out, None


def compute_mesh_diameter(model_pts: np.ndarray, n_sample: int = 10000) -> float:
    """Max pairwise distance over the convex hull of the points.

    The reference samples 10k points and takes the max pairwise distance
    (Utils.py:559-574, called from estimater.py:54); the hull gives the
    same value deterministically (diameter is attained at hull vertices)
    without the O(n^2) memory blowup on this 1-core host.
    """
    pts = np.asarray(model_pts, dtype=np.float64)
    if len(pts) > 4:
        try:
            from scipy.spatial import ConvexHull

            pts = pts[ConvexHull(pts).vertices]
        except Exception:
            if len(pts) > n_sample:
                stride = int(np.ceil(len(pts) / n_sample))
                pts = pts[::stride]
    dists = np.linalg.norm(pts[None] - pts[:, None], axis=-1)
    return float(dists.max())


def texture_to_vertex_colors(mesh: TriMesh) -> TriMesh:
    """Sample the texture at each vertex UV -> per-vertex colors.

    At hypothesis-crop scale (faces of a render-budgeted mesh cover ~1-2
    pixels of a 160x160 crop) per-vertex appearance is visually
    equivalent to per-pixel texture sampling and removes the per-pixel
    texture gathers from the hot render loop.
    """
    if not mesh.has_texture:
        return mesh
    out = mesh.copy()
    uv = np.clip(mesh.uv, 0.0, 1.0)
    Ht, Wt = mesh.texture.shape[:2]
    x = np.clip((uv[:, 0] * Wt).astype(int), 0, Wt - 1)
    y = np.clip(((1.0 - uv[:, 1]) * Ht).astype(int), 0, Ht - 1)
    out.vertex_colors = mesh.texture[y, x]
    out.uv = None
    out.texture = None
    return out


def decimate_vertex_clustering(mesh: TriMesh, voxel_size: float) -> TriMesh:
    """Mesh simplification by vertex clustering on a voxel grid.

    Collapses all vertices inside each voxel to their mean and drops
    degenerate faces. Intended for bounding rasterization cost on very
    dense meshes (the 160x160 hypothesis crops resolve nothing below
    ~1/160 of the object extent). Texture coordinates do not survive
    clustering; textured meshes are converted to per-vertex colors
    sampled from the texture first.
    """
    vertex_colors = mesh.vertex_colors
    if mesh.has_texture:
        # Sample the texture at each vertex's UV (nearest texel).
        uv = np.clip(mesh.uv, 0.0, 1.0)
        Ht, Wt = mesh.texture.shape[:2]
        x = np.clip((uv[:, 0] * Wt).astype(int), 0, Wt - 1)
        y = np.clip(((1.0 - uv[:, 1]) * Ht).astype(int), 0, Ht - 1)
        vertex_colors = mesh.texture[y, x]

    mins = mesh.vertices.min(axis=0)
    idx = np.floor((mesh.vertices - mins) / voxel_size).astype(np.int64)
    key = (idx[:, 0] << 42) + (idx[:, 1] << 21) + idx[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    n_new = len(uniq)
    verts = np.zeros((n_new, 3))
    cnt = np.zeros((n_new, 1))
    np.add.at(verts, inv, mesh.vertices)
    np.add.at(cnt, inv, 1.0)
    verts /= cnt
    colors = None
    if vertex_colors is not None:
        colors = np.zeros((n_new, 3))
        np.add.at(colors, inv, vertex_colors[:, :3].astype(np.float64))
        colors = (colors / cnt).astype(np.uint8)
    faces = inv[mesh.faces]
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return TriMesh(vertices=verts, faces=faces[ok], vertex_colors=colors)


def add_pure_colored_texture(mesh: TriMesh, color=(255, 255, 255), resolution: int = 5) -> TriMesh:
    """Uniform-color appearance for untextured CAD models (Utils.py:658-662,
    TlessReader), as per-vertex colors: the renderer treats flat vertex
    colors and a flat texture alike. `resolution` is the reference's
    texture size, unused here."""
    out = mesh.copy()
    out.vertex_colors = np.tile(np.asarray(color, np.uint8).reshape(1, 3), (len(out.vertices), 1))
    out.uv = None
    out.texture = None
    return out
