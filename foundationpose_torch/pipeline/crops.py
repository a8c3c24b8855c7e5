"""Hypothesis crops: render + observation warp + XYZ centering.

Port of foundationpose_tpu/pipeline/crops.py (the reference's
make_crop_data_batch and dataset transform). Every hypothesis is
rendered straight into its crop, the observation is warped once per
hypothesis, and both XYZ maps are re-centered on the hypothesis
translation (optionally normalized by the mesh radius). Outputs are
NHWC 6-channel network inputs (9 with use_normal).
"""
from __future__ import annotations

import torch

from .. import torch_config  # noqa: F401
from ..geometry.projection import compute_crop_window_tf
from ..ops.rasterizer import render_mesh
from ..ops.warp import warp_crop
from .mesh_tensors import MeshTensors


def make_crop_inputs(
    mesh: MeshTensors,
    poses: torch.Tensor,  # (N, 4, 4)
    K: torch.Tensor,  # (3, 3)
    rgb: torch.Tensor,  # (H, W, 3) f32 in [0, 1]
    xyz_map: torch.Tensor,  # (H, W, 3) observation camera-space XYZ
    mesh_diameter,
    *,
    input_res: int,
    crop_ratio: float,
    normalize_xyz: bool,
    invalid_z: float,
    use_light: bool = True,
    use_normal: bool = False,
    raster=None,
):
    """Returns (A, B, tf_to_crops): A/B (N, res, res, 6) f32, or 9
    channels with use_normal (raw camera-space normals appended;
    observation normals from xyz-map finite differences)."""
    res = int(input_res)
    tf_to_crops = compute_crop_window_tf(poses, K, crop_ratio, res, mesh_diameter)
    rend = render_crops(mesh, poses, K, tf_to_crops, res, use_light=use_light,
                        use_normal=use_normal, raster=raster)
    rgb_b = warp_crop(rgb, tf_to_crops, (res, res), mode="bilinear")
    xyz_b = warp_crop(xyz_map, tf_to_crops, (res, res), mode="nearest")

    radius = mesh_radius(mesh_diameter, poses.device) if normalize_xyz else None

    def center(xyz):
        return center_xyz(xyz, poses, radius, invalid_z)

    a_cols = [rend.color, center(rend.xyz)]
    b_cols = [rgb_b, center(xyz_b)]
    if use_normal:
        a_cols.append(rend.normal)
        b_cols.append(
            warp_crop(normals_from_xyz(xyz_map), tf_to_crops, (res, res), mode="nearest")
        )
    return torch.cat(a_cols, dim=-1), torch.cat(b_cols, dim=-1), tf_to_crops


def render_crops(mesh: MeshTensors, poses, K, tf_to_crops, res: int, *, use_light=True,
                 use_normal=False, raster=None):
    """Each pose of `mesh` rendered straight into its res x res crop."""
    return render_mesh(
        mesh.pos,
        mesh.faces,
        poses,
        K,
        out_hw=(res, res),
        crop_tf=tf_to_crops,
        vertex_color=mesh.vertex_color,
        uv=mesh.uv,
        tex=mesh.tex,
        vnormals=mesh.vnormals,
        use_light=use_light,
        get_normal=use_normal,
        cull_backfaces=bool(raster is not None and raster.cull_backfaces),
    )


def mesh_radius(mesh_diameter, device) -> torch.Tensor:
    return torch.as_tensor(mesh_diameter, dtype=torch.float32, device=device) / 2.0


def center_xyz(xyz, poses, radius, invalid_z: float):
    """(N, H, W, 3) camera-space XYZ re-centered on each pose's translation;
    with a `radius` (normalize_xyz) divided by it and zeroed where the
    depth is below invalid_z or a coordinate reaches 2 radii."""
    out = xyz - poses[:, :3, 3][:, None, None, :]
    if radius is not None:
        out = out / radius
        invalid = (xyz[..., 2:3] < invalid_z) | (torch.abs(out) >= 2)
        out = torch.where(invalid, torch.zeros_like(out), out)
    return out


def normals_from_xyz(xyz_map: torch.Tensor) -> torch.Tensor:
    """Camera-space normals of an (H, W, 3) XYZ map by central
    differences; zero where depth is invalid, oriented toward the camera."""
    valid = xyz_map[..., 2] > 1e-6
    dx = torch.zeros_like(xyz_map)
    dx[:, 1:-1] = xyz_map[:, 2:] - xyz_map[:, :-2]
    dy = torch.zeros_like(xyz_map)
    dy[1:-1] = xyz_map[2:] - xyz_map[:-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    flip = torch.sum(n * xyz_map, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    ok = (
        valid
        & torch.roll(valid, 1, 0) & torch.roll(valid, -1, 0)
        & torch.roll(valid, 1, 1) & torch.roll(valid, -1, 1)
    )
    return torch.where(ok[..., None], n, torch.zeros_like(n))
