"""Work of one neural-object-field step, counted from the configuration's
widths and the batch's shapes (the model FLOPs of flops.py's convention:
2 a multiply-add of the linear layers, backward at twice the forward; the
bytes a kernel's algorithm must move, so a roofline reads the same work
whoever implements it)."""
from __future__ import annotations

from .reference.nerf import level_tables


def mlp_flops_per_point(cfg: dict) -> int:
    """NeRFSmall's forward at one point: the sigma net (L C -> hidden -> 1 +
    geo) and the colour net (SH + frame features + geo -> hidden -> hidden
    -> 3)."""
    hidden, geo = cfg["mlp_hidden"], cfg["geo_features"]
    views = cfg["multires_views"] ** 2 + cfg["frame_features"]
    layers = ((cfg["num_levels"] * cfg["feature_grid_dim"], hidden), (hidden, 1 + geo), (views + geo, hidden),
              (hidden, hidden), (hidden, 3))
    return sum(2 * a * b for a, b in layers)


def points_per_step(cfg: dict) -> int:
    return cfg["n_rand"] * (cfg["n_samples"] + cfg["n_samples_around_depth"])


def step_flops(cfg: dict) -> int:
    """The MLP's forward and backward over a step's points."""
    return 3 * mlp_flops_per_point(cfg) * points_per_step(cfg)


def grid_grad_bytes(cfg: dict, points: float) -> float:
    """The table gradient's least bytes for `points` points: each point read
    (3 f32) with its cotangent (L C f32), the (rows, C) f32 gradient
    written once."""
    L, C = cfg["num_levels"], cfg["feature_grid_dim"]
    return points * (3 + L * C) * 4 + level_tables(cfg)[3] * C * 4
