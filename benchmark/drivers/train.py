"""The traffic kind `train`: a closed loop of refiner training steps, each
`make_refiner_batch` on fresh seeded draws followed by
`refine_train_step`, on one net and one Adam.

Set-up runs the first `warm_steps` steps through the window's own call.
`check` has the reference follow those steps from the same initial
weights and draws (each step's loss, the first gradient, the change after
the last), and one window step drawn from the seed from the program's own
state just before it (its loss, its gradient, its change): the state
after many steps exists only in the program, and the steps before it are
judged by the first comparison."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import flops, traffic, weights
from benchmark.reference.pipeline import Crops, Mesh, train_steps

B1 = 0.9  # Adam's first-moment decay, as training.make_optimizer sets it


def leaf_gaps(prog: dict, ref: dict) -> list:
    """|norm(prog leaf) - norm(ref leaf)| of each leaf, against the larger of
    its reference norm and the median leaf's."""
    rn = {k: float(torch.linalg.norm(ref[k].double())) for k in ref}
    med = float(np.median(list(rn.values())))
    return [abs(float(torch.linalg.norm(prog[k].double())) - rn[k]) / max(rn[k], med) for k in ref]


def step_gaps(grad_p, grad_r, moved_p, moved_r) -> dict:
    """A step's gradient and change against the reference's, leaf by leaf,
    over the entries whose reference gradient is at least 1e-3 of the
    median leaf's root mean square entry: the rest are nought to rounding
    (the key's third of each attention in-projection bias, under softmax)
    and move under Adam by round-off alone. -> the median leaf's gaps and,
    beside them, the worst leaf's."""
    rms = [float(torch.linalg.norm(g.double())) / g.numel() ** 0.5 for g in grad_r.values()]
    floor = 1e-3 * float(np.median(rms))
    resolved = {k: g.abs() >= floor for k, g in grad_r.items()}
    keep = [k for k, m in resolved.items() if m.any()]
    grad = leaf_gaps({k: grad_p[k][resolved[k]] for k in keep}, {k: grad_r[k][resolved[k]] for k in keep})
    moved = leaf_gaps({k: moved_p[k][resolved[k]] for k in keep}, {k: moved_r[k][resolved[k]] for k in keep})
    return {"grad_gap": float(np.median(grad)), "update_gap": float(np.median(moved)),
            "grad_worst_leaf": max(grad), "update_worst_leaf": max(moved)}


class Driver:
    def __init__(self, cfg, tr, seed, device):
        from foundationpose_torch.meshio import TriMesh
        from foundationpose_torch.models import training
        from foundationpose_torch.models.networks import RefineNet, RefineNetCfg
        from foundationpose_torch.pipeline import make_mesh_tensors
        from foundationpose_torch.pipeline.config import RasterCfg, RefinerCfg

        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.batch = tr["batch"]
        verts, faces, colors = traffic.bench_mesh(cfg, seed)
        self.mesh = Mesh.from_arrays(verts, faces, colors, device)
        centered = self.mesh.pos.double().cpu().numpy()
        self.mt = make_mesh_tensors(TriMesh(vertices=centered, faces=faces, vertex_colors=colors), device=device)
        self.Kt = torch.as_tensor(traffic.intrinsics(cfg), device=device)
        self.diam = torch.tensor(self.mesh.diameter, dtype=torch.float32, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.sd0 = weights.refiner_state(cfg, gen, device)
        self.draw_gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.rcfg = RefinerCfg(net=RefineNetCfg(base_width=cfg["base_width"], num_heads=cfg["num_heads"]),
                               input_res=cfg["input_res"], crop_ratio=cfg["crop_ratio"],
                               compute_dtype=cfg["compute_dtype"],
                               raster=RasterCfg(cull_backfaces=cfg["cull_backfaces"]))
        self.tcfg = training.TrainCfg(lr=cfg["lr"], loss_type=cfg["loss"], compute_dtype=cfg["compute_dtype"])
        self.net = RefineNet(self.rcfg.net)
        self.net.load_state_dict(self.sd0)
        self.opt = training.make_optimizer(self.tcfg, self.net, device)
        self.spans = None
        self.draws, self.losses = [], []
        for k in range(tr["warm_steps"]):
            self.draws.append(traffic.train_draws(self.draw_gen, self.batch))
            self.losses.append(self._step(self.draws[-1]))
            if k == 0:
                self.first = self._snapshot()
        self.after = self._snapshot()
        self.check_step = int(np.random.default_rng([seed, 5]).integers(tr["check_window_steps"]))
        self.window_step = None
        self.served = 0

    def _snapshot(self):
        """Each float tensor of the net with Adam's first and second moments
        of it (nought before Adam holds state of it), by state-dict name,
        and Adam's step count."""
        st, out, t = self.opt.state, {}, torch.zeros(())
        for k, x in self.net.state_dict(keep_vars=True).items():
            if x.is_floating_point():
                s = st.get(x) or {"exp_avg": torch.zeros_like(x), "exp_avg_sq": torch.zeros_like(x)}
                out[k] = (x.detach().clone(), s["exp_avg"].clone(), s["exp_avg_sq"].clone())
                t = s["step"].clone() if "step" in s else t
        return out, t

    def _step(self, draws):
        from foundationpose_torch.datasets import make_refiner_batch
        from foundationpose_torch.models import training

        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if self.spans is not None else None
        if marks:
            marks[0].record()
        batch = make_refiner_batch(None, self.mt, self.Kt, self.rcfg, self.diam, n=self.batch,
                                   draws={"pairs": draws})
        if marks:
            marks[1].record()
        loss = training.refine_train_step(self.net, self.opt, self.tcfg, batch)
        if marks:
            marks[2].record()
            self.spans.append(marks)
        return loss

    def request(self):
        draws = traffic.train_draws(self.draw_gen, self.batch)
        if self.served != self.check_step:
            self._step(draws)
        else:
            before = self._snapshot()
            loss = self._step(draws)
            self.window_step = (draws, before, self._snapshot(), loss)
        self.served += 1

    def trace_spans(self):
        """CUDA events around each traced step's batch and update."""
        self.spans = [] if self.device.type == "cuda" else None
        return self.spans

    def flops_per_request(self):
        return flops.train_step(self.batch, self.cfg["base_width"], self.cfg["input_res"])

    def free(self):
        del self.net, self.opt
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _reference(self, state, draws, quant, moments=None):
        c = self.cfg
        crops = Crops(res=c["input_res"], crop_ratio=c["crop_ratio"], invalid_z=0.001, cull=c["cull_backfaces"])
        return train_steps(state, self.mesh, self.Kt, draws, crops, c["lr"], c["num_heads"], quant, moments)

    def check(self, rng, control=False):
        """The first steps: the worst step's relative loss gap, the first
        gradient as Adam holds it (exp_avg / (1 - b1)) and each leaf's
        change after the last step. The window step: its loss, its gradient
        ((exp_avg after - b1 exp_avg before) / (1 - b1)) and its change,
        the reference starting from the tensors and Adam's moments the
        program held before it. With `control` the reference computed in
        fp8 stands in the program's place."""
        losses = [float(x) for x in self.losses]
        (first, _), (after, _) = self.first, self.after
        grad_p = {k: m / (1 - B1) for k, (_, m, _) in first.items()}
        moved_p = {k: after[k][0].float() - self.sd0[k] for k in grad_p}
        self.free()
        r_losses, r_grad, r_leaves = self._reference(self.sd0, self.draws, None)
        if control:
            losses, grad_p, leaves = self._reference(self.sd0, self.draws, "fp8")
            moved_p = {k: leaves[k] - self.sd0[k] for k in grad_p}
        out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(losses, r_losses))}
        out |= step_gaps(grad_p, {k: r_grad[k] for k in grad_p}, moved_p,
                         {k: r_leaves[k] - self.sd0[k] for k in grad_p})
        if self.window_step is None:  # the window ended before the drawn step: nothing judged it
            return out | {"step_" + k: float("inf") for k in ("loss_gap", "grad_gap", "update_gap")}
        draws, (before, t), (later, _), loss = self.window_step
        state = {k: x for k, (x, _, _) in before.items()}
        moments = ({k: m for k, (_, m, _) in before.items()}, {k: v for k, (_, _, v) in before.items()}, int(t))
        r_loss, r_grad, r_leaves = self._reference(state, [draws], None, moments)
        grad_p = {k: (later[k][1] - B1 * before[k][1]) / (1 - B1) for k in state}
        moved_p = {k: later[k][0] - state[k] for k in state}
        loss = float(loss)
        if control:
            (loss,), grad_p, leaves = self._reference(state, [draws], "fp8", moments)
            moved_p = {k: leaves[k] - state[k] for k in state}
        step = step_gaps(grad_p, r_grad, moved_p, {k: r_leaves[k] - state[k] for k in state})
        return out | {"step_loss_gap": abs(loss - r_loss[0]) / abs(r_loss[0])} | {
            "step_" + k: v for k, v in step.items()}
