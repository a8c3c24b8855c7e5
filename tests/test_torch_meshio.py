"""foundationpose_torch.meshio, the port's copy of the numpy mesh helpers,
against foundationpose_tpu.meshio on the same inputs: results equal
exactly, and the port's helpers return the port's own TriMesh."""
import numpy as np
import pytest

from foundationpose_torch import meshio as tm
from foundationpose_tpu import meshio as jm


def _mesh(mod, textured=False, seed=0):
    """A bumpy 320-face icosphere with vertex colors (and a texture)."""
    from foundationpose_torch.geometry.icosphere import icosphere

    rng = np.random.default_rng(seed)
    verts, faces = icosphere(2, radius=0.1)
    verts = verts * (1 + 0.1 * rng.uniform(size=(len(verts), 1)))
    mesh = mod.TriMesh(vertices=verts, faces=faces,
                       vertex_colors=rng.integers(0, 255, (len(verts), 3)).astype(np.uint8))
    if textured:
        mesh.uv = rng.uniform(0, 1, (len(verts), 2)).astype(np.float32)
        mesh.texture = rng.integers(0, 255, (16, 24, 3)).astype(np.uint8)
    return mesh


def _assert_same_mesh(a, b):
    assert type(a).__module__ == "foundationpose_torch.meshio"
    for f in ("vertices", "faces", "vertex_colors", "uv", "texture"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("case", ["make_box", "normals", "copy_bounds", "texture_to_vertex_colors",
                                  "decimate", "decimate_textured"])
def test_mesh_helpers_match_reference(case):
    if case == "make_box":
        a, b = tm.make_box(np.array([0.1, 0.2, 0.3])), jm.make_box(np.array([0.1, 0.2, 0.3]))
        _assert_same_mesh(a, b)
        np.testing.assert_array_equal(a.vertex_normals, b.vertex_normals)
    elif case == "normals":
        a, b = _mesh(tm), _mesh(jm)
        np.testing.assert_array_equal(a.vertex_normals, b.vertex_normals)
        np.testing.assert_array_equal(tm.compute_vertex_normals(a.vertices, a.faces), b.vertex_normals)
    elif case == "copy_bounds":
        a, b = _mesh(tm, textured=True), _mesh(jm, textured=True)
        _assert_same_mesh(a.copy(), b.copy())
        np.testing.assert_array_equal(a.bounds(), b.bounds())
        assert a.has_texture and b.has_texture
    elif case == "texture_to_vertex_colors":
        _assert_same_mesh(tm.texture_to_vertex_colors(_mesh(tm, textured=True)),
                          jm.texture_to_vertex_colors(_mesh(jm, textured=True)))
    else:
        textured = case == "decimate_textured"
        _assert_same_mesh(tm.decimate_vertex_clustering(_mesh(tm, textured), 0.02),
                          jm.decimate_vertex_clustering(_mesh(jm, textured), 0.02))


@pytest.mark.parametrize("with_normals", [False, True])
def test_voxel_downsample_matches_reference(with_normals):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(5000, 3)) * 0.1
    nrm = rng.normal(size=(5000, 3)) if with_normals else None
    pa, na = tm.voxel_downsample(pts, 0.01, nrm)
    pb, nb = jm.voxel_downsample(pts, 0.01, nrm)
    np.testing.assert_array_equal(pa, pb)
    assert (na is None) == (nb is None)
    if na is not None:
        np.testing.assert_array_equal(na, nb)


@pytest.mark.parametrize("n", [4, 300, 20000])
def test_mesh_diameter_matches_reference(n):
    pts = np.random.default_rng(n).uniform(-0.1, 0.1, (n, 3))
    assert tm.compute_mesh_diameter(pts) == jm.compute_mesh_diameter(pts)


@pytest.mark.parametrize("fmt", ["obj", "obj_textured", "ply_ascii", "ply_binary"])
def test_load_mesh_matches_reference(tmp_path, fmt):
    """Files written by the reference's exporters (and a binary PLY made
    here) load to the same arrays through both loaders."""
    mesh = _mesh(jm, textured=fmt == "obj_textured")
    if fmt.startswith("obj"):
        path = str(tmp_path / "m.obj")
        jm.export_obj(mesh, path)
    elif fmt == "ply_ascii":
        path = str(tmp_path / "m.ply")
        jm.export_ply(mesh, path)
    else:
        path = str(tmp_path / "m.ply")
        v = np.zeros(len(mesh.vertices), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                                ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        for k, name in enumerate("xyz"):
            v[name] = mesh.vertices[:, k]
        for k, name in enumerate(("red", "green", "blue")):
            v[name] = mesh.vertex_colors[:, k]
        f = np.zeros(len(mesh.faces), dtype=[("n", "u1"), ("i", "<i4", (3,))])
        f["n"], f["i"] = 3, mesh.faces
        header = (
            f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element face {len(f)}\nproperty list uchar int vertex_indices\nend_header\n"
        )
        with open(path, "wb") as fh:
            fh.write(header.encode() + v.tobytes() + f.tobytes())
    _assert_same_mesh(tm.load_mesh(path), jm.load_mesh(path))


def test_export_obj_matches_reference(tmp_path):
    mesh_t, mesh_j = _mesh(tm, textured=True), _mesh(jm, textured=True)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    mesh_t.export(str(tmp_path / "t" / "m.obj"))
    mesh_j.export(str(tmp_path / "j" / "m.obj"))
    for name in ("m.obj", "m.mtl", "m.png"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
