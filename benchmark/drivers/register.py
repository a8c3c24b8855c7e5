"""The traffic kind `register`: a closed loop of FoundationPose.register,
each on the next of the traffic's seeded frames.

Set-up registers every frame `warm_passes` times, so that each window key
the loop reaches has run eagerly and been captured before the window.
`check` measures a seeded sample of served registers of distinct frames
against the reference: every valid hypothesis's refined pose against the
reference's register, every logit against the reference scorer's logit
of the same pose, and the chosen hypothesis by that scorer; the traffic
file's limits say which numbers decide `correct`."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import flops, traffic
from benchmark.estimating import Estimating, ranked, register_numbers


class Driver(Estimating):
    def __init__(self, cfg, tr, seed, device):
        hw = (cfg["frame_height"], cfg["frame_width"])
        super().__init__(cfg, seed, device, traffic.register_poses(tr, traffic.intrinsics(cfg), hw, seed))
        self.tr = tr
        self.iters = cfg["register_iterations"]
        for _ in range(tr["warm_passes"]):
            for f in self.frames:
                self.est.register(self.K, *f, iteration=self.iters)
        self.recoveries_in_setup = self.est.register_roi_recoveries
        self.n_hyp = len(self.grid()[0])
        self.served = []

    def request(self):
        i = len(self.served) % len(self.frames)
        self.est.register(self.K, *self.frames[i], iteration=self.iters)
        self.served.append((i, self.est.order, self.est.poses, self.est.scores))

    def end_window(self):
        self.recoveries_in_window = self.est.register_roi_recoveries - self.recoveries_in_setup

    def flops_per_request(self):
        c = self.cfg
        return flops.register(self.n_hyp, self.iters, c["base_width"], c["input_res"])

    def sample(self, rng, k):
        """Up to k served registers of distinct frames, drawn from the seed."""
        firsts = {}
        for j, rec in enumerate(self.served):
            firsts.setdefault(rec[0], j)
        pick = rng.permutation(sorted(firsts.values()))[:k]
        return [self.served[j] for j in sorted(pick)]

    @torch.no_grad()
    def check(self, rng, control=False):
        """The worst of each number over the sample, and the median
        register's `logit_gap`: a frame whose hypotheses' logits spread
        little reads up to twice the others' (0.40 against 0.08-0.20 std).
        With `control`, the reference computed in fp8 stands in the
        program's place."""
        recs = self.sample(rng, self.tr["check_registers"])
        self.free()
        ref, (grid, valid) = self.reference(), self.grid()
        out = []
        for i, order, refined, scores in recs:
            frame = self.frame_tensors(self.frames[i])
            if control:
                order, refined, scores = ranked(*self.reference("fp8").register(*frame, grid, valid, self.iters))
            ref_refined, _ = ref.register(*frame, grid, valid, self.iters)
            out.append(register_numbers(ref, frame, valid, ref_refined, order, refined, scores))
        return {k: (float(np.median([o[k] for o in out])) if k == "logit_gap" else max(o[k] for o in out))
                for k in out[0]}
