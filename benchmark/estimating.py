"""What the register and track drivers share: the object, its frames, the
seeded weights, the program's estimator and the reference estimator, and
the numbers a register is judged by."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import traffic, weights
from benchmark.reference import geometry as G
from benchmark.reference import nets
from benchmark.reference.pipeline import Crops, Estimator, Mesh, crop_inputs, filter_depth, guess_center, xyz_map


def estimator_cfg(cfg: dict):
    """The program's EstimatorCfg for a configuration file."""
    from foundationpose_torch.models.networks import RefineNetCfg, ScoreNetCfg
    from foundationpose_torch.pipeline.config import EstimatorCfg, RasterCfg, RefinerCfg, ScorerCfg

    raster = RasterCfg(cull_backfaces=cfg["cull_backfaces"])
    net = dict(base_width=cfg["base_width"], num_heads=cfg["num_heads"])
    crops = dict(input_res=cfg["input_res"], crop_ratio=cfg["crop_ratio"], compute_dtype=cfg["compute_dtype"],
                 raster=raster)
    return EstimatorCfg(refiner=RefinerCfg(net=RefineNetCfg(**net), **crops),
                        scorer=ScorerCfg(net=ScoreNetCfg(**net), mode=cfg["scorer"], **crops),
                        min_n_views=cfg["n_views"], inplane_step_deg=cfg["inplane_step_deg"], **cfg["uploads"])


def register_numbers(ref: Estimator, frame, valid, ref_refined, order, refined, scores) -> dict:
    """A register's gaps to the reference, per hypothesis in grid order (the
    program's order undone): the refined pose's translation (mm), rotation
    (deg) and ADD (mm) against the reference's own register
    (`ref_refined`), the widest; the logit against the reference scorer's logit of the same
    refined pose, the median hypothesis's and the widest; and how far the
    reference's logit of the chosen hypothesis lies below its best. The
    logit numbers are over the spread (standard deviation) of the
    reference's valid logits. Scoring the program's own poses keeps out of
    the scorer's comparison a crop box that a pose's last digits round to
    the other whole pixel. The widest logit gap has a long tail: the
    scorer's self-attention over its 400 tokens is nearly one-hot at these
    weights, and bf16's rounding of a query moves a few hypotheses to
    another token."""
    n = order.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=order.device)
    poses, logits = refined[inv], scores[inv]
    dt, dr = G.pose_gap(poses[valid], ref_refined[valid])
    K, rgb, depth, _ = frame
    judged = ref.judge(poses, K, rgb, depth, valid).double()
    spread = float(judged[valid].std())
    gap = (logits[valid].double() - judged[valid]).abs() / spread
    add = G.add_gap(poses[valid], ref_refined[valid], ref.mesh.pos)
    return {"trans_gap_mm": float(dt.max()) * 1e3, "rot_gap_deg": float(dr.max()), "add_mm": float(add.max()) * 1e3,
            "logit_gap": float(gap.median()), "logit_gap_max": float(gap.max()),
            "pick_gap": float(judged[valid].max() - judged[int(order[0])]) / spread}


def ranked(refined, scores):
    """A reference register's output in the program's form: (order, refined
    and scores best first)."""
    order = torch.argsort(-scores, stable=True)
    return order, refined[order], scores[order]


class Estimating:
    """The object, its frames at `poses`, the weights and both estimators."""

    def __init__(self, cfg: dict, seed: int, device, poses: np.ndarray):
        from foundationpose_torch.meshio import TriMesh
        from foundationpose_torch.pipeline import FoundationPose

        self.cfg, self.seed, self.device = cfg, seed, device
        self.K = traffic.intrinsics(cfg)
        self.hw = (cfg["frame_height"], cfg["frame_width"])
        verts, faces, colors = traffic.bench_mesh(cfg, seed)
        self.mesh = Mesh.from_arrays(verts, faces, colors, device)
        self.frames = traffic.render_frames(self.mesh, poses, self.K, self.hw, device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.sd_refiner = weights.refiner_state(cfg, gen, device)
        scorer = weights.scorer_state(cfg, gen, device)
        self.sd_scorer = weights.spread_scorer(scorer, self.pooled_mean(scorer), cfg["score_attention_scale"])
        self.est = FoundationPose(mesh=TriMesh(vertices=verts, faces=faces, vertex_colors=colors),
                                  cfg=estimator_cfg(cfg), refiner_params=self.sd_refiner,
                                  scorer_params=self.sd_scorer, device=device)

    def crops(self, invalid_z):
        c = self.cfg
        return Crops(res=c["input_res"], crop_ratio=c["crop_ratio"], invalid_z=invalid_z, cull=c["cull_backfaces"])

    @torch.no_grad()
    def pooled_mean(self, sd, n=32):
        """The reference scorer's pooled features (f32, no TF32), averaged
        over up to n valid hypotheses of the first frame, drawn from the
        seed and placed at the frame's guessed center."""
        K, rgb, depth, mask = self.frame_tensors(self.frames[0])
        grid, valid = self.grid()
        ok = np.flatnonzero(valid.cpu().numpy())
        idx = np.random.default_rng([self.seed, 4]).choice(ok, min(n, len(ok)), replace=False)
        d = filter_depth(depth)
        poses = grid[torch.as_tensor(idx, device=grid.device)].clone()
        poses[:, :3, 3] = guess_center(d, mask, K)[None]
        a, b = crop_inputs(self.mesh, poses, K, rgb.float() / 255.0, xyz_map(d, K), self.crops(0.1))
        with nets.plain_scope():
            return nets.score_pooled(sd, a, b, self.cfg["num_heads"]).mean(0)

    def reference(self, quant=None):
        return Estimator(self.mesh, self.sd_refiner, self.sd_scorer, heads=self.cfg["num_heads"],
                         refine_crops=self.crops(0.001), score_crops=self.crops(0.1), quant=quant)

    def grid(self):
        grid, valid = G.rotation_grid(self.cfg["n_views"], self.cfg["inplane_step_deg"], 30.0, 4)
        dev = self.device
        return (torch.as_tensor(grid, dtype=torch.float32, device=dev), torch.as_tensor(valid, device=dev))

    def frame_tensors(self, f):
        dev = self.device
        return (torch.as_tensor(self.K, device=dev), torch.as_tensor(f[0], device=dev),
                torch.as_tensor(f[1], device=dev), torch.as_tensor(f[2], device=dev))

    def free(self):
        del self.est
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
