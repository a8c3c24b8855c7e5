"""Synthetic refiner and scorer training batches, rendered on the device.

Port of foundationpose_tpu/datasets/synthetic.py: sample a gt pose and a
perturbed hypothesis, render both into their crops and emit the network
inputs with delta targets in the network's output space (the exact
inverse of pipeline/refiner.py::apply_pose_delta). On the card every
render is the tile rasterizer's (K1); nothing is read back to the host.

Randomness. Each function first draws its random values from a
`torch.Generator` on the batch's device (`key`: a generator, or an int
seed for one) and then runs a deterministic body on the draws. A caller
may pass `draws=` instead: a dict of the values the JAX function's
`jax.random` calls produce, with their shapes and ranges (the layouts
are in `_pair_draws`, `_occlude_crop_draws`, `_occlude_frame_draws`,
`make_refiner_batch` and `make_scorer_batch`). The tests hold the bodies
against the JAX package that way; the generator's streams differ from
`jax.random`'s.

`make_refiner_batch` of the JAX package also warps two all-zero frames
into observation crops that it then discards; the port does not build
them, so it takes no `frame_hw`.
"""
from __future__ import annotations

import torch

from .. import torch_config  # noqa: F401
from ..geometry.projection import compute_crop_window_tf
from ..geometry.rotations import so3_exp_map, so3_log_map
from ..geometry.transforms import make_pose, pose_to_egocentric_delta_pose
from ..ops.rasterizer import render_mesh
from ..pipeline.config import RefinerCfg
from ..pipeline.crops import center_xyz, make_crop_inputs, mesh_radius, render_crops
from ..pipeline.mesh_tensors import MeshTensors
from ..torch_config import default_device


def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        if key.device.type != torch.device(device).type:
            raise ValueError(f"generator on {key.device}, batch on {device}")
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def _normal(g, shape):
    return torch.randn(shape, generator=g, device=g.device)


def _uniform(g, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


# ------------------------------------------------------------ pose pairs


def _pair_draws(g, n):
    """jax.random.split(key, 4) -> normal (n, 3) each: w_gt, t_gt, dw, dt."""
    return {k: _normal(g, (n, 3)) for k in ("w_gt", "t_gt", "dw", "dt")}


def _pose_pairs(d, center_dist, trans_sigma, rot_sigma):
    R_gt = so3_exp_map(d["w_gt"] * 1.5)
    noise = d["t_gt"]
    t_gt = torch.stack(
        [noise[:, 0] * 0.05, noise[:, 1] * 0.05, noise[:, 2] * 0.1 + center_dist], dim=-1
    )
    poseB = make_pose(R_gt, t_gt)
    dR = so3_exp_map(d["dw"] * rot_sigma)
    poseA = make_pose(dR @ R_gt, t_gt + d["dt"] * trans_sigma)
    return poseA, poseB


def sample_pose_pairs(
    key,
    n: int,
    center_dist: float = 0.8,
    trans_sigma: float = 0.01,
    rot_sigma: float = 0.15,
    *,
    device="cuda",
    draws: dict | None = None,
):
    """(poseA perturbed (n, 4, 4), poseB gt (n, 4, 4)) with random
    rotations. `key` (a generator, or a seed for one on `device`; without
    a card "cuda" raises) or `draws` (`_pair_draws`)."""
    if draws is None:
        dev = key.device if isinstance(key, torch.Generator) else default_device(device)
        draws = _pair_draws(_generator(key, dev), n)
    return _pose_pairs(draws, center_dist, trans_sigma, rot_sigma)


def delta_targets(poseA, poseB, cfg: RefinerCfg, mesh_diameter):
    """Network-output-space targets that invert apply_pose_delta.

    tracknet + normalize_xyz: trans_out = dt / (diameter / 2); else
    atanh(dt / trans_normalizer), clipped to +-0.999; rot (axis-angle):
    atanh(log(dR^T) / rot_normalizer), clipped the same way."""
    dt, dR = pose_to_egocentric_delta_pose(poseA, poseB)
    if cfg.normalize_xyz:
        trans_t = dt / mesh_radius(mesh_diameter, dt.device)
    else:
        scaled = torch.stack([dt[..., i] / cfg.trans_normalizer[i] for i in range(3)], dim=-1)
        trans_t = torch.arctanh(torch.clamp(scaled, -0.999, 0.999))
    w = so3_log_map(dR.transpose(-1, -2))
    rot_t = torch.arctanh(torch.clamp(w / cfg.rot_normalizer, -0.999, 0.999))
    return trans_t, rot_t


# ------------------------------------------------------------ occluders


def _occlude_crop_draws(g, n, res, max_frac):
    """jax.random.split(key, 4) -> center, half, apply, col."""
    return {
        "center": _uniform(g, (n, 2), 0.1 * res, 0.9 * res),
        "half": _uniform(g, (n, 2), 0.08 * res, max_frac * res / 2),
        "apply": _uniform(g, (n,)),
        "col": _uniform(g, (n, 1, 1, 3), 0.05, 0.9),
    }


def _occlude_crops(key, b, prob, max_frac, draws: dict | None = None):
    """Foreground-occluder augmentation of observation crops (n, res, res,
    C >= 6): with probability `prob` per sample, a random rectangle
    (half-extent up to max_frac * res / 2 per axis) becomes a flat random
    color with every geometry channel zeroed, what a real occluder leaves
    after make_crop_inputs' invalid-depth masking."""
    n, res = b.shape[0], b.shape[1]
    d = draws if draws is not None else _occlude_crop_draws(
        _generator(key, b.device), n, res, max_frac)
    center, half = d["center"], d["half"]
    px = torch.arange(res, dtype=torch.float32, device=b.device)
    in_x = torch.abs(px[None, None, :] - center[:, 0, None, None]) < half[:, 0, None, None]
    in_y = torch.abs(px[None, :, None] - center[:, 1, None, None]) < half[:, 1, None, None]
    occ = (in_x & in_y & (d["apply"] < prob)[:, None, None])[..., None]
    color = torch.where(occ, d["col"], b[..., :3])
    geom = torch.where(occ, torch.zeros_like(b[..., 3:]), b[..., 3:])
    return torch.cat([color, geom], dim=-1)


def _occlude_frame_draws(g, max_frac):
    """jax.random.split(key, 4) -> apply, c, half, col."""
    return {
        "apply": _uniform(g, ()),
        "c": _uniform(g, (2,), -0.6, 0.6),
        "half": _uniform(g, (2,), 0.25, max_frac),
        "col": _uniform(g, (3,), 0.05, 0.9),
    }


def _occlude_frame(key, color, xyz, center_px, r_px, prob, max_frac, draws: dict | None = None):
    """Frame-space occluder of a scorer batch: one rectangle for the whole
    hypothesis group (every crop views the same observation) within the
    object's projected extent; flat random color, geometry zeroed."""
    d = draws if draws is not None else _occlude_frame_draws(_generator(key, color.device), max_frac)
    c = center_px + d["c"] * r_px
    half = d["half"] * r_px
    H, W = color.shape[:2]
    ux = torch.arange(W, dtype=torch.float32, device=color.device)[None, :]
    uy = torch.arange(H, dtype=torch.float32, device=color.device)[:, None]
    occ = ((torch.abs(ux - c[0]) < half[0]) & (torch.abs(uy - c[1]) < half[1])
           & (d["apply"] < prob))[..., None]
    return (torch.where(occ, d["col"], color),
            torch.where(occ, torch.zeros_like(xyz), xyz))


# ------------------------------------------------------------ batches


def make_refiner_batch(
    key,
    mesh: MeshTensors,
    K: torch.Tensor,
    cfg: RefinerCfg,
    mesh_diameter,
    n: int = 16,
    rot_sigma: float = 0.15,
    trans_sigma: float = 0.01,
    occlude_prob: float = 0.0,
    occlude_max_frac: float = 0.5,
    *,
    draws: dict | None = None,
):
    """A synthetic refiner batch on the mesh's device: the hypothesis (A,
    at the perturbed pose) and the observation (B, at gt) rendered into
    the hypothesis's crop, two renders in all. -> {'A', 'B',
    'trans_target', 'rot_target', 'poseA', 'poseB'}. rot/trans_sigma set
    the perturbation scale; occlude_prob applies `_occlude_crops` to B.

    draws: {'pairs': `_pair_draws`} (JAX: the first of split(key, 3)),
    plus 'occlude' (`_occlude_crop_draws`, the third) when
    occlude_prob > 0."""
    dev = mesh.pos.device
    if draws is None:
        g = _generator(key, dev)
        draws = {"pairs": _pair_draws(g, n)}
        if occlude_prob > 0:
            draws["occlude"] = _occlude_crop_draws(g, n, cfg.input_res, occlude_max_frac)
    poseA, poseB = _pose_pairs(draws["pairs"], 0.8, trans_sigma, rot_sigma)
    res = int(cfg.input_res)
    tf_to_crops = compute_crop_window_tf(poseA, K, cfg.crop_ratio, res, mesh_diameter)
    radius = mesh_radius(mesh_diameter, dev) if cfg.normalize_xyz else None
    # The observation follows the hypothesis's crop: both are centered on poseA.
    a, b = (
        torch.cat([r.color, center_xyz(r.xyz, poseA, radius, cfg.xyz_invalid_z)], dim=-1)
        for r in (render_crops(mesh, p, K, tf_to_crops, res, raster=cfg.raster)
                  for p in (poseA, poseB))
    )
    if occlude_prob > 0:
        b = _occlude_crops(None, b, occlude_prob, occlude_max_frac, draws=draws["occlude"])
    trans_t, rot_t = delta_targets(poseA, poseB, cfg, mesh_diameter)
    return {"A": a, "B": b, "trans_target": trans_t, "rot_target": rot_t,
            "poseA": poseA, "poseB": poseB}


def make_scorer_batch(
    key,
    mesh: MeshTensors,
    K: torch.Tensor,
    cfg,  # ScorerCfg
    mesh_diameter,
    n: int = 16,
    frame_hw: tuple[int, int] = (120, 160),
    rot_sigma: float = 1.2,
    trans_sigma: float = 0.03,
    scene_seed: int | None = None,
    occlude_prob: float = 0.0,
    occlude_max_frac: float = 0.7,
    *,
    draws: dict | None = None,
):
    """One hypothesis group around one gt pose for the scorer's
    contrastive loss (models/training.py::score_loss_fn): the frame is
    rendered at gt, the n hypotheses carry graded perturbations (the
    first exact, the last at registration-grid scale), and 'target'
    holds ADD-derived soft logits (-ADD / (0.05 d)). `scene_seed` pins
    the gt pose of every call (fixed-scene training) while `key` varies
    the perturbations. Two renders: the frame, then the crops.

    draws: {'scene': `_pair_draws` of n = 1 (JAX: the first of
    split(key, 4), or scene_key), 'dw', 'dt': normal (n, 3) (the second
    and third), 'occlude': `_occlude_frame_draws` (the fourth) when
    occlude_prob > 0}."""
    dev = mesh.pos.device
    if draws is None:
        g = _generator(key, dev)
        scene = g if scene_seed is None else _generator(scene_seed, dev)
        draws = {"scene": _pair_draws(scene, 1), "dw": _normal(g, (n, 3)), "dt": _normal(g, (n, 3))}
        if occlude_prob > 0:
            draws["occlude"] = _occlude_frame_draws(g, occlude_max_frac)
    gt = _pose_pairs(draws["scene"], 0.8, 0.01, 0.15)[1][0]

    # jnp.linspace(0, 1, n): i / (n - 1), correctly rounded
    scales = (torch.arange(n, dtype=torch.float32, device=dev) / max(n - 1, 1))[:, None]
    dR = so3_exp_map(draws["dw"] * rot_sigma * scales)
    hyp = make_pose(dR @ gt[:3, :3], gt[:3, 3] + draws["dt"] * trans_sigma * scales)

    out = render_mesh(
        mesh.pos, mesh.faces, gt[None], K, out_hw=tuple(frame_hw),
        vertex_color=mesh.vertex_color, uv=mesh.uv, tex=mesh.tex,
        vnormals=mesh.vnormals, use_light=True,
        cull_backfaces=cfg.raster.cull_backfaces,
    )
    color_f, xyz_f = out.color[0], out.xyz[0]
    diam = torch.as_tensor(mesh_diameter, dtype=torch.float32, device=dev)
    if occlude_prob > 0:
        z = gt[2, 3]
        f = (K[0, 0] + K[1, 1]) / 2.0
        center_px = torch.stack(
            [K[0, 0] * gt[0, 3] / z + K[0, 2], K[1, 1] * gt[1, 3] / z + K[1, 2]]
        )
        r_px = f * diam / 2.0 / z
        color_f, xyz_f = _occlude_frame(None, color_f, xyz_f, center_px, r_px, occlude_prob,
                                        occlude_max_frac, draws=draws["occlude"])
    a, b, _tf = make_crop_inputs(
        mesh, hyp, K, color_f, xyz_f, mesh_diameter,
        input_res=cfg.input_res, crop_ratio=cfg.crop_ratio,
        normalize_xyz=cfg.normalize_xyz, invalid_z=cfg.xyz_invalid_z,
        use_normal=cfg.use_normal, raster=cfg.raster,
    )
    pts_h = torch.einsum("nij,pj->npi", hyp[:, :3, :3], mesh.pos) + hyp[:, None, :3, 3]
    pts_g = mesh.pos @ gt[:3, :3].T + gt[:3, 3]
    add = torch.linalg.norm(pts_h - pts_g[None], dim=-1).mean(dim=-1)
    target = -add / (0.05 * diam)
    return {"A": a, "B": b, "target": target, "poses": hyp, "gt": gt, "add": add}
