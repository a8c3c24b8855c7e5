"""The traffic kind `score_train`: a closed loop of scorer training steps,
each `make_scorer_batch` on fresh seeded draws (one hypothesis group: the
frame rendered at a ground-truth pose, the group's hypotheses rendered
into their crops, the observation warped into the same crops, the
ADD-derived targets) followed by `score_train_step`, on one net and one
Adam.

The seeded weights (`weights.scorer_state`) are shaped from the
reference's f32 view of the first group (`shaped_scorer`), so that the
group's logits depend on each hypothesis's own features and Adam's first
steps at the configuration's lr leave them so. Set-up runs the first
`warm_steps` steps through the window's own call. `check` follows
drivers/train.py: the reference (benchmark/reference/score_train.py)
follows those steps from the same initial weights and draws (each step's
loss, the first gradient, the change after the last), and recomputes one
window step drawn from the seed from the program's own tensors and Adam
moments just before it: its loss, gradient and change (train-refiner's
norm gaps, drivers/train.py::step_gaps; each leaf's distance,
drivers/nerf.py::step_dists, beside them), and the forward the program
ran in that step, its 64 pooled features and logits against the
reference's f32 forward of the program's own crops."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import flops, traffic, weights
from benchmark.drivers.nerf import step_dists
from benchmark.drivers.train import B1, step_gaps
from benchmark.drivers.train import Driver as TrainDriver
from benchmark.reference import nets
from benchmark.reference import score_train as ref
from benchmark.reference.pipeline import Crops, Mesh


def group_draws(gen: torch.Generator, n: int) -> dict:
    """One group's normal draws, in make_scorer_batch's layout: 'scene' (a
    pair's w_gt, t_gt, dw, dt, (1, 3) each), 'dw' and 'dt' (n, 3)."""
    scene = traffic.train_draws(gen, 1)
    return {"scene": scene, "dw": torch.randn((n, 3), generator=gen, device=gen.device),
            "dt": torch.randn((n, 3), generator=gen, device=gen.device)}


# Each convolution of the trunk and the BN after it.
CONV_BN = ((".net.0", ".net.1"), (".conv1", ".bn1"), (".conv2", ".bn2"))
LAST_STAGE_BLOCKS = ("encoderAB.3", "encoderAB.4")


def scaled_convs(sd: dict, c: float) -> dict:
    """Each convolution's weight and bias times c and its BN's statistics to
    match (mean x c, variance x c^2): the same function, but an Adam step,
    about lr an entry whatever the gradient's size, moves each convolution's
    output c times less (at c = 1 a step of 1e-4 moves it ~10-16%: the BN
    statistics are trained leaves here, and nothing renormalises)."""
    out = dict(sd)
    for name in sd:
        for conv, bn in CONV_BN:
            if name.endswith(conv + ".weight"):
                base = name[:-len(conv + ".weight")]
                for k, f in ((conv + ".weight", c), (conv + ".bias", c), (bn + ".running_mean", c),
                             (bn + ".running_var", c * c)):
                    out[base + k] = sd[base + k] * f
    return out


def shrunk_last_stage(sd: dict, k: float) -> dict:
    """The trunk's last stage (the stride-2 layer and its two blocks) with its
    output divided by k: their BN scales and shifts, and the biases and
    statistics in front of each block's first BN."""
    out = dict(sd)
    for x in ("weight", "bias"):
        out["encoderAB.2.net.1." + x] = sd["encoderAB.2.net.1." + x] / k
    for blk in LAST_STAGE_BLOCKS:
        for name, f in ((".conv1.bias", 1 / k), (".bn1.running_mean", 1 / k), (".bn1.running_var", 1 / k ** 2),
                        (".bn2.weight", 1 / k), (".bn2.bias", 1 / k)):
            out[blk + name] = sd[blk + name] * f
    return out


def shaped_scorer(sd: dict, A, B, heads: int, conv_scale: float, token_shrink: float, att_std: float,
                  cross_score: float) -> dict:
    """The scorer's seeded state dict shaped from the reference's f32 forward
    of one group's crops A, B, so that Adam at lr 1e-4 does not tie the
    group's logits within the steps the check reaches. A random net has
    no normalisation here, and Adam's first steps move every entry by
    about lr: each layer's output shifts coherently, the pooled features'
    common part grows several times their spread over the group in one
    step, the cross-hypothesis attention (which compares them around
    their first mean) turns one-hot on one hypothesis for all, and every
    logit is the same. So:
    - `scaled_convs(conv_scale)`: the trunk's convolutions hardly move;
    - `shrunk_last_stage(token_shrink)` and the pair self-attention's
      projections times `token_shrink`: tokens near the positions' size
      (~16) with projections large against lr;
    - the self-attention's queries and keys scaled alike so that its
      scores spread with standard deviation `att_std` (near-uniform at
      the start, trained from there), its values centred on the group's
      mean token;
    - the cross-hypothesis attention made to compare the pooled features
      by `weights.spread_scorer` around their mean over the group, at the
      scale that gives a hypothesis's score with itself `cross_score` on
      average in each head."""
    sd = shrunk_last_stage(scaled_convs(sd, conv_scale), token_shrink)
    d = sd["att.in_proj_weight"].shape[1]
    dh = d // heads
    w, b = sd["att.in_proj_weight"] * token_shrink, sd["att.in_proj_bias"].clone()
    with torch.no_grad(), nets.plain_scope():
        t = nets.tokens(sd, "encoderA", "encoderAB", A, B, None)
        q, k = ((t @ w[i * d:(i + 1) * d].T + b[i * d:(i + 1) * d]).unflatten(-1, (heads, dh)).transpose(1, 2)
                for i in (0, 1))
        g = math.sqrt(att_std / float((q @ k.transpose(-1, -2) / math.sqrt(dh)).std()))
        w[:2 * d] *= g
        b[:2 * d] *= g
        b[2 * d:] -= w[2 * d:] @ t.mean((0, 1))
        sd = sd | {"att.in_proj_weight": w, "att.in_proj_bias": b}
        feats = nets.score_pooled(sd, A, B, heads)
    mu = feats.mean(0)
    scale = math.sqrt(cross_score * heads * math.sqrt(dh) / float(((feats - mu) ** 2).sum(1).mean()))
    return weights.spread_scorer(sd, mu, scale)


def rel_gap(p, r) -> float:
    """|p - r| / |r| over the whole tensor; inf where the shapes differ."""
    if p.shape != r.shape:
        return float("inf")
    return float(torch.linalg.norm((p - r).double()) / torch.linalg.norm(r.double()))


class Driver:
    def __init__(self, cfg, tr, seed, device):
        from foundationpose_torch.meshio import TriMesh
        from foundationpose_torch.models import training
        from foundationpose_torch.models.networks import ScoreNetCfg, ScoreNetMultiPair
        from foundationpose_torch.pipeline import make_mesh_tensors
        from foundationpose_torch.pipeline.config import RasterCfg, ScorerCfg

        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.n = tr["group"]
        verts, faces, colors = traffic.bench_mesh(cfg, seed)
        self.mesh = Mesh.from_arrays(verts, faces, colors, device)
        centered = self.mesh.pos.double().cpu().numpy()
        self.mt = make_mesh_tensors(TriMesh(vertices=centered, faces=faces, vertex_colors=colors), device=device)
        self.Kt = torch.as_tensor(traffic.intrinsics(cfg), device=device)
        self.diam = torch.tensor(self.mesh.diameter, dtype=torch.float32, device=device)
        self.crops = Crops(res=cfg["input_res"], crop_ratio=cfg["crop_ratio"], invalid_z=cfg["xyz_invalid_z"],
                           cull=cfg["cull_backfaces"])
        self.draw_gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.draws = [group_draws(self.draw_gen, self.n) for _ in range(tr["warm_steps"])]
        gen = torch.Generator(device=device).manual_seed(seed)
        first = self._ref_batch(self.draws[0])
        self.sd0 = shaped_scorer(weights.scorer_state(cfg, gen, device), first["A"], first["B"], cfg["num_heads"],
                                 cfg["score_conv_scale"], cfg["score_token_shrink"],
                                 cfg["score_self_attention_std"], cfg["score_cross_self_score"])
        del first
        self.scfg = ScorerCfg(net=ScoreNetCfg(base_width=cfg["base_width"], num_heads=cfg["num_heads"]),
                              input_res=cfg["input_res"], crop_ratio=cfg["crop_ratio"],
                              normalize_xyz=cfg["normalize_xyz"], xyz_invalid_z=cfg["xyz_invalid_z"],
                              use_normal=cfg["use_normal"], mode="network", compute_dtype=cfg["compute_dtype"],
                              raster=RasterCfg(cull_backfaces=cfg["cull_backfaces"]))
        self.tcfg = training.TrainCfg(lr=cfg["lr"], compute_dtype=cfg["compute_dtype"])
        self.net = ScoreNetMultiPair(self.scfg.net)
        self.net.load_state_dict(self.sd0)
        self.opt = training.make_optimizer(self.tcfg, self.net, device)
        self.spans = None
        self.losses = []
        for k, draws in enumerate(self.draws):
            self.losses.append(self._step(draws))
            if k == 0:
                self.first = self._snapshot()
        self.after = self._snapshot()
        self.check_step = int(np.random.default_rng([seed, 5]).integers(tr["check_window_steps"]))
        self.window_step = None
        self.served = 0

    def _ref_batch(self, draws):
        t = self.tr
        return ref.group_batch(self.mesh, self.Kt, draws, self.n, t["rot_sigma"], t["trans_sigma"], t["frame_hw"],
                               self.crops, t["center_m"])

    _snapshot = TrainDriver._snapshot  # the net's float tensors, Adam's moments and step count

    def _step(self, draws, seen=None):
        """One step; with `seen` (a dict) the forward's pooled features and
        logits, read by hooks as the step computes them, and the crops."""
        from foundationpose_torch.datasets import make_scorer_batch
        from foundationpose_torch.models import training

        t = self.tr
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if self.spans is not None else None
        if marks:
            marks[0].record()
        batch = make_scorer_batch(None, self.mt, self.Kt, self.scfg, self.diam, n=self.n,
                                  frame_hw=tuple(t["frame_hw"]), rot_sigma=t["rot_sigma"],
                                  trans_sigma=t["trans_sigma"], occlude_prob=t["occlude_prob"], draws=draws)
        if marks:
            marks[1].record()
        hooks = []
        if seen is not None:
            seen |= {"A": batch["A"], "B": batch["B"]}
            hooks = [self.net.att.register_forward_hook(
                         lambda m, i, o: seen.__setitem__("feats", o.detach().mean(dim=1).float())),
                     self.net.linear.register_forward_hook(
                         lambda m, i, o: seen.__setitem__("logits", o.detach()[0, :, 0].float()))]
        loss = training.score_train_step(self.net, self.opt, self.tcfg, batch)
        for h in hooks:
            h.remove()
        if marks:
            marks[2].record()
            self.spans.append(marks)
        return loss

    def request(self):
        draws = group_draws(self.draw_gen, self.n)
        if self.served != self.check_step:
            self._step(draws)
        else:
            before, seen = self._snapshot(), {}
            loss = self._step(draws, seen)
            self.window_step = (draws, before, self._snapshot(), loss, seen)
        self.served += 1

    def trace_spans(self):
        """CUDA events around each traced step's batch and update."""
        self.spans = [] if self.device.type == "cuda" else None
        return self.spans

    def flops_per_request(self):
        """Forward over the group (each pair's trunk and self-attention, the
        cross-hypothesis attention and logit), and backward at twice it."""
        w, res = self.cfg["base_width"], self.cfg["input_res"]
        return 3 * (self.n * flops.score_pair(w, res) + flops.score_group(self.n, w))

    def free(self):
        del self.net, self.opt
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _reference(self, state, batches, quant, moments=None):
        return ref.train_steps(state, batches, self.cfg["lr"], self.cfg["num_heads"], quant, moments)

    @staticmethod
    def _gaps(grad_p, grad_r, moved_p, moved_r) -> dict:
        """drivers/train.py::step_gaps, and beside them each leaf's distance
        (drivers/nerf.py::step_dists) over the leaves the reference moved (the
        BN variances of 1e4 that `scaled_convs` leaves stay put in f32 under
        a step of 1e-4)."""
        kept = [k for k, r in moved_r.items() if bool(r.any())]
        dist = step_dists(*({k: x[k] for k in kept} for x in (grad_p, grad_r, moved_p, moved_r)))
        return step_gaps(grad_p, grad_r, moved_p, moved_r) | {
            "grad_dist": dist["grad_gap"], "update_dist": dist["update_gap"],
            "grad_dist_worst_leaf": dist["grad_worst_leaf"], "update_dist_worst_leaf": dist["update_worst_leaf"]}

    def check(self, rng, control=False):
        """The first steps: the worst step's relative loss gap, the first
        gradient as Adam holds it (exp_avg / (1 - b1)) and each leaf's
        change after the last step. The window step: its loss, its gradient
        ((exp_avg after - b1 exp_avg before) / (1 - b1)) and its change,
        the reference starting from the tensors and Adam's moments the
        program held before it; and that step's forward, the pooled features
        and logits the program computed, against the reference's f32
        forward of the program's crops from the same tensors: relative
        gaps of the features, of their deviations from the group's mean
        and of the logits' (`step_feat_gap`, `step_feat_dev_gap`,
        `step_logit_gap`). With `control` the reference computed in fp8
        stands in the program's place."""
        losses = [float(x) for x in self.losses]
        (first, _), (after, _) = self.first, self.after
        grad_p = {k: m / (1 - B1) for k, (_, m, _) in first.items()}
        moved_p = {k: after[k][0].float() - self.sd0[k] for k in grad_p}
        self.free()
        batches = [self._ref_batch(d) for d in self.draws]
        r_losses, r_grad, r_leaves = self._reference(self.sd0, batches, None)
        if control:
            losses, grad_p, leaves = self._reference(self.sd0, batches, "fp8")
            moved_p = {k: leaves[k] - self.sd0[k] for k in grad_p}
        out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(losses, r_losses))}
        out |= self._gaps(grad_p, {k: r_grad[k] for k in grad_p}, moved_p,
                          {k: r_leaves[k] - self.sd0[k] for k in grad_p})
        if self.window_step is None:  # the window ended before the drawn step: nothing judged it
            return out | {"step_" + k: float("inf") for k in (
                "loss_gap", "grad_gap", "update_gap", "feat_gap", "feat_dev_gap", "logit_gap")}
        draws, (before, t), (later, _), loss, seen = self.window_step
        state = {k: x for k, (x, _, _) in before.items()}
        moments = ({k: m for k, (_, m, _) in before.items()}, {k: v for k, (_, _, v) in before.items()}, int(t))
        batch = [self._ref_batch(draws)]
        r_loss, r_grad, r_leaves = self._reference(state, batch, None, moments)
        grad_p = {k: (later[k][1] - B1 * before[k][1]) / (1 - B1) for k in state}
        moved_p = {k: later[k][0] - state[k] for k in state}
        loss = float(loss)
        if control:
            (loss,), grad_p, leaves = self._reference(state, batch, "fp8", moments)
            moved_p = {k: leaves[k] - state[k] for k in state}
        step = self._gaps(grad_p, r_grad, moved_p, {k: r_leaves[k] - state[k] for k in state})
        heads = self.cfg["num_heads"]
        with torch.no_grad(), nets.plain_scope():
            f_r = nets.score_pooled(state, seen["A"], seen["B"], heads)
            l_r = nets.score_logits(state, f_r, heads)
            if control:
                f_p = nets.score_pooled(state, seen["A"], seen["B"], heads, "fp8")
                l_p = nets.score_logits(state, f_p, heads, "fp8")
            else:
                f_p, l_p = seen["feats"], seen["logits"]
        return out | {"step_loss_gap": abs(loss - r_loss[0]) / abs(r_loss[0])} | {
            "step_" + k: v for k, v in step.items()} | {
            "step_feat_gap": rel_gap(f_p, f_r), "step_feat_dev_gap": rel_gap(f_p - f_p.mean(0), f_r - f_r.mean(0)),
            "step_logit_gap": rel_gap(l_p - l_p.mean(), l_r - l_r.mean())}

