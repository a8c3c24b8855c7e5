"""The traffic kind `nerf`: a closed loop of neural-object-field training
steps, each `NerfRunner.step(seed)`, the step `NerfRunner.train` takes
(its device generator seeded from the seed and the step, then
`train_step`).

Set-up renders the reference views of the configuration's object with the
benchmark's plain renderer (benchmark/traffic.py), builds the runner from
them as `run_neural_object_field` does (`nerf.make_runner`: scene bounds,
normalization, `NerfRunner`), and runs the first `warm_steps` steps
through the window's own call. `check` follows drivers/train.py's
principle, each gradient and change judged leaf by leaf by its distance
from the reference's (`step_dists`): the reference follows those steps
from the initial parameters and the same draws (each step's loss, the
first clipped gradient as Adam holds it, the change after the last), and
recomputes one window step drawn from the seed from the program's
parameters and Adam moments just before it. The draws are drawn again
from the seed (`NerfRunner.step_draws`), bit for bit those the step took.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import nerf_work, traffic
from benchmark.drivers.train import B1
from benchmark.reference import nerf as ref
from benchmark.reference.pipeline import Mesh


def step_dists(grad_p, grad_r, moved_p, moved_r) -> dict:
    """A step's gradient and change against the reference's, leaf by leaf,
    over the entries drivers/train.py::step_gaps keeps (reference gradient
    at least 1e-3 of the median leaf's root mean square entry), as the
    distance |prog - ref| / |ref|. step_gaps' difference of the two norms
    reads rounding, which turns a leaf more than it stretches it, only to
    second order: the fp8 control read 1.4-2x the sound seeds' largest
    there. -> the median leaf's distances and, beside them, the worst
    leaf's."""
    rms = [float(torch.linalg.norm(g.double())) / g.numel() ** 0.5 for g in grad_r.values()]
    floor = 1e-3 * float(np.median(rms))
    grad, moved = [], []
    for k, g in grad_r.items():
        m = g.abs() >= floor
        if m.any():
            for out, p, r in ((grad, grad_p, grad_r), (moved, moved_p, moved_r)):
                out.append(float(torch.linalg.norm((p[k][m] - r[k][m]).double()) / torch.linalg.norm(r[k][m].double())))
    return {"grad_gap": float(np.median(grad)), "update_gap": float(np.median(moved)),
            "grad_worst_leaf": max(grad), "update_worst_leaf": max(moved)}


def view_poses(tr: dict, seed: int) -> np.ndarray:
    """Object-in-camera poses of the views: a camera `distance_m` from the
    object's centre at every `azimuth_step_deg` of azimuth at each of
    `elevations_deg`, looking at the centre with the object's z up (OpenCV
    axes: x right, y down, z forward); the object turned by a seeded
    rotation, as `traffic.video_poses` turns it."""
    turn = np.eye(4)
    turn[:3, :3] = traffic.random_rotation(np.random.default_rng([seed, 3]))
    out = []
    for el in np.deg2rad(tr["elevations_deg"]):
        for az in np.deg2rad(np.arange(0, 360, tr["azimuth_step_deg"])):
            eye = tr["distance_m"] * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            cam = np.eye(4)
            cam[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=1)
            cam[:3, 3] = eye
            out.append(np.linalg.inv(cam) @ turn)
    return np.stack(out)


def nerf_cfg(cfg: dict):
    """The configuration's NerfCfg: its keys that are NerfCfg fields, the
    rest at their defaults."""
    import dataclasses

    from foundationpose_torch.nerf import NerfCfg

    fields = {f.name for f in dataclasses.fields(NerfCfg)}
    return NerfCfg(**{k: v for k, v in cfg.items() if k in fields})


def render_views(cfg: dict, tr: dict, seed: int, device):
    """-> K, rgbs (V, H, W, 3) u8, depths (V, H, W) m, masks (V, H, W) u8,
    cam_in_obs (V, 4, 4): the views of the centered bench mesh."""
    verts, faces, colors = traffic.bench_mesh(cfg, seed)
    mesh = Mesh.from_arrays(verts, faces, colors, device)
    K = traffic.intrinsics(cfg)
    poses = view_poses(tr, seed)
    if len(poses) != cfg["views"]:
        raise ValueError(f"the traffic lays out {len(poses)} views; the configuration has {cfg['views']}")
    frames = traffic.render_frames(mesh, poses, K, (cfg["frame_height"], cfg["frame_width"]), device)
    rgbs, depths, masks = (np.stack(x) for x in zip(*frames))
    return K, rgbs, depths, masks, np.linalg.inv(poses)


class Driver:
    def __init__(self, cfg, tr, seed, device):
        from foundationpose_torch import nerf

        make_runner = nerf.make_runner  # a program without it cannot run the cell: fail before set-up
        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        K, rgbs, depths, masks, cam_in_obs = render_views(cfg, tr, seed, device)
        self.runner = make_runner(nerf_cfg(cfg), K, rgbs, depths, masks, cam_in_obs, seed=seed, device=device)
        self.p0 = self._params()
        self.losses = []
        for k in range(tr["warm_steps"]):
            self.losses.append(self.runner.step(seed)[0])
            if k == 0:
                self.mu1 = {n: m.clone() for n, m in self.runner.opt["mu"].items()}
        self.after = self._params()
        self.check_step = int(np.random.default_rng([seed, 5]).integers(tr["check_window_steps"]))
        self.window_step = None
        self.points_before = 0
        self.served = 0

    def _params(self):
        return {n: p.detach().clone() for n, p in self.runner.model.named_parameters()}

    def request(self):
        r = self.runner
        if self.served != self.check_step:
            r.step(self.seed)
        else:
            it, opt = r.global_step, r.opt
            before = (self._params(), {n: m.clone() for n, m in opt["mu"].items()},
                      {n: v.clone() for n, v in opt["nu"].items()}, opt["count"])
            loss, _ = r.step(self.seed)
            self.window_step = (it, before, self._params(), {n: m.clone() for n, m in opt["mu"].items()}, loss)
        self.served += 1

    def trace_spans(self):
        """Before the traced stretch: the count of points encoded so far
        (the recorder's counter nerf.points), which the stretch's count is
        read against."""
        from foundationpose_torch.utils import profiling

        self.points_before = profiling.counters().get("nerf.points", 0)
        return None

    def flops_per_request(self):
        return nerf_work.step_flops(self.cfg)

    def _reference(self, params, draws, quant, moments=None):
        return ref.train_steps(params, self.data, draws, self.cfg, quant, moments)

    def check(self, rng, control=False):
        """The warm steps: the worst step's relative loss gap, the first
        clipped gradient as Adam holds it (exp_avg / (1 - b1)), each leaf's
        change after the last (`step_dists`). The window
        step: its loss, its gradient ((exp_avg after - b1 exp_avg before) /
        (1 - b1)) and its change, the reference starting from the
        parameters and moments the program held before it. With `control`
        the reference computed in fp8 stands in the program's place."""
        r = self.runner
        self.data = {k: r.rays[k] for k in ("dir", "rgb", "depth", "frame_id")}
        self.data |= {"occ": r.occ, "c2w": r.c2w, "sc_factor": r.cfg.sc_factor}
        warm = [r.step_draws(self.seed, it)[:3] for it in range(self.tr["warm_steps"])]
        window = None if self.window_step is None else r.step_draws(self.seed, self.window_step[0])[:3]
        del self.runner, r
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        losses = [float(x) for x in self.losses]
        grad_p = {k: m / (1 - B1) for k, m in self.mu1.items()}
        moved_p = {k: self.after[k] - self.p0[k] for k in self.p0}
        r_losses, r_grad, r_params = self._reference(self.p0, warm, None)
        if control:
            losses, grad_p, leaves = self._reference(self.p0, warm, "fp8")
            moved_p = {k: leaves[k] - self.p0[k] for k in self.p0}
        out = {"loss_gap": max(abs(p - q) / abs(q) for p, q in zip(losses, r_losses))}
        out |= step_dists(grad_p, r_grad, moved_p, {k: r_params[k] - self.p0[k] for k in self.p0})
        if window is None:  # the window ended before the drawn step: nothing judged it
            return out | {"step_" + k: float("inf") for k in ("loss_gap", "grad_gap", "update_gap")}
        _, (state, mu, nu, count), later, mu_after, loss = self.window_step
        moments = (mu, nu, count)
        (r_loss,), r_grad, r_params = self._reference(state, [window], None, moments)
        grad_p = {k: (mu_after[k] - B1 * mu[k]) / (1 - B1) for k in state}
        moved_p = {k: later[k] - state[k] for k in state}
        loss = float(loss)
        if control:
            (loss,), grad_p, leaves = self._reference(state, [window], "fp8", moments)
            moved_p = {k: leaves[k] - state[k] for k in state}
        step = step_dists(grad_p, r_grad, moved_p, {k: r_params[k] - state[k] for k in state})
        return out | {"step_loss_gap": abs(loss - r_loss) / abs(r_loss)} | {
            "step_" + k: v for k, v in step.items()}
