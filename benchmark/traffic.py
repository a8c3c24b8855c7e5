"""The benchmark's one generator of inputs: the object mesh, RGB-D frames
rendered by the reference's plain renderer, a video's poses and training
draws, each made from the seed and a traffic file's parameters.

Every seed gets the same set of sizes: the register frames' depths are
fixed points of the traffic's band, dealt in a seeded order; the video's
path is fixed and the seed turns the object; training draws are normals
of fixed shapes. Depth is on a grid of 0.25 mm, f32(k) x f32(1 / 4000):
a sensor's integer depth units, and exactly what the program's packed
upload (u16 in 0.25 mm) carries, so the upload loses nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import geometry as G
from .reference.render import render


def bench_mesh(cfg: dict, seed: int):
    """icosphere(subdivisions) of `radius_m` with a radial bump
    1 + bump sin(8 z), vertex colors from the seed: (vertices, faces, colors u8)."""
    m = cfg["mesh"]
    verts, faces = G.icosphere(m["subdivisions"], m["radius_m"])
    verts = verts * (1.0 + m["bump"] * np.sin(8 * verts[:, 2:3]))
    colors = np.random.default_rng([seed, 1]).integers(30, 255, (len(verts), 3)).astype(np.uint8)
    return verts, faces, colors


def intrinsics(cfg: dict) -> np.ndarray:
    return np.array([[cfg["fx"], 0, cfg["frame_width"] / 2], [0, cfg["fy"], cfg["frame_height"] / 2],
                     [0, 0, 1]], np.float32)


def random_rotation(rng) -> np.ndarray:
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def render_frames(mesh, poses: np.ndarray, K: np.ndarray, hw, device, block=8):
    """Frames of the mesh (reference.pipeline.Mesh) at object-in-camera
    poses of the centered mesh -> [(rgb u8 (H, W, 3), depth f32 m on the
    0.25 mm grid (H, W), mask u8 (H, W))] as numpy arrays."""
    P = torch.as_tensor(poses, dtype=torch.float32, device=device)
    Kt = torch.as_tensor(K, device=device)
    out = []
    for s in range(0, len(P), block):
        col, xyz, mask = render(mesh.pos, mesh.faces, mesh.color, mesh.normals, P[s:s + block], Kt, hw)
        rgb = torch.round(col * 255).to(torch.uint8).cpu().numpy()
        depth = (torch.round(xyz[..., 2] * 4000).to(torch.float32) * (1.0 / 4000)).cpu().numpy()
        m = mask.to(torch.uint8).cpu().numpy()
        out += [(rgb[i], depth[i], m[i]) for i in range(len(rgb))]
    return out


def register_poses(traffic: dict, K: np.ndarray, hw, seed: int) -> np.ndarray:
    """One pose a frame: a uniform random rotation, the depth dealt from
    `frames` evenly spaced points of `depth_m`, the center at up to
    `offset_px` from the principal point."""
    rng = np.random.default_rng([seed, 2])
    n = traffic["frames"]
    zs = rng.permutation(np.linspace(*traffic["depth_m"], n))
    P = np.tile(np.eye(4), (n, 1, 1))
    for i, z in enumerate(zs):
        du, dv = rng.uniform(-traffic["offset_px"], traffic["offset_px"], 2)
        P[i, :3, :3] = random_rotation(rng)
        P[i, :3, 3] = [du * z / K[0, 0], dv * z / K[1, 1], z]
    return P


def video_poses(traffic: dict, seed: int) -> np.ndarray:
    """`frames` poses: the object turned by a seeded rotation, then
    `turn_deg` a frame about the camera's y axis while its center moves
    `step_m` a frame from `start_m`."""
    R0 = random_rotation(np.random.default_rng([seed, 3]))
    n = traffic["frames"]
    P = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = np.deg2rad(traffic["turn_deg"] * i)
        Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        P[i, :3, :3] = Ry @ R0
        P[i, :3, 3] = np.asarray(traffic["start_m"]) + i * np.asarray(traffic["step_m"])
    return P


def train_draws(gen: torch.Generator, n: int) -> dict:
    """One refiner batch's normal draws (n, 3): w_gt, t_gt, dw, dt."""
    return {k: torch.randn((n, 3), generator=gen, device=gen.device) for k in ("w_gt", "t_gt", "dw", "dt")}
