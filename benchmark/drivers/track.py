"""The traffic kind `track`: a closed loop of FoundationPose.track_one over
a seeded video, played forward then back so that the motion stays
continuous.

Set-up registers the first frame once and tracks one whole pass, so that
every upload window the loop reaches is captured before the window. Each
pass starts from the registered pose, and its upload window from that
pose's host copy, as after a register: a random refiner drifts, and the
passes would not be the same work otherwise.

`check` compares the start (the set-up register) with the reference's;
a seeded sample of served frames, each tracked by the reference from the
pose the program handed it; and the window's first `chain_frames` frames
against the reference's own chain, tracked from the reference's refined
pose of the hypothesis the program chose, with no pose of the program's
in between."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import flops, traffic
from benchmark.estimating import Estimating, ranked, register_numbers
from benchmark.reference import geometry as G


class Driver(Estimating):
    def __init__(self, cfg, tr, seed, device):
        super().__init__(cfg, seed, device, traffic.video_poses(tr, seed))
        self.tr = tr
        self.iters = cfg["track_iterations"]
        n = tr["frames"]
        self.cycle = list(range(n)) + list(range(n - 2, 0, -1))
        self.est.register(self.K, *self.frames[0], iteration=cfg["register_iterations"])
        self.start, self.start_hint = self.est.pose_last, self.est._pose_hint.copy()
        self.start_out = (self.est.order, self.est.poses, self.est.scores)
        self.served = []
        for _ in self.cycle:
            self.request()
        self.served = []
        self.recoveries_in_setup = self.est.track_stats["roi_recoveries"]

    def request(self):
        j = len(self.served) % len(self.cycle)
        if j == 0:
            self.est.pose_last = self.start.clone()
            self.est._pose_hint = self.start_hint.copy()
        pose_in = self.est.pose_last
        f = self.frames[self.cycle[j]]
        self.est.track_one(f[0], f[1], self.K, iteration=self.iters)
        self.served.append((self.cycle[j], pose_in, self.est.pose_last))

    def end_window(self):
        self.recoveries_in_window = self.est.track_stats["roi_recoveries"] - self.recoveries_in_setup

    def flops_per_request(self):
        return flops.track_frame(self.iters, self.cfg["base_width"], self.cfg["input_res"])

    def _track(self, est, pose, i):
        K, rgb, depth, _ = self.frame_tensors(self.frames[i])
        return est.track(pose, K, rgb, depth, self.iters)

    @torch.no_grad()
    def check(self, rng, control=False):
        """A pose's gap is its translation (mm), its rotation (deg) and the
        ADD of the object's vertices between it and the reference's (mm),
        which sums both: the fp8 control's rounding moves the pose along
        translation on some seeds and along rotation on others. The frames'
        gaps are their median, and beside it the widest: a crop box that
        the first iteration's last digits round to the other whole pixel
        moves the second iteration's delta of a few frames. With `control`
        the reference computed in fp8 stands in the program's place: its
        register, its frames and its chain."""
        pick = sorted(rng.choice(len(self.served), min(self.tr["check_frames"], len(self.served)), replace=False))
        recs = [self.served[j] for j in pick]
        n_chain = min(self.tr["chain_frames"], len(self.served))
        chain = [out for _, _, out in self.served[:n_chain]]
        self.free()
        ref, low, (grid, valid) = self.reference(), self.reference("fp8"), self.grid()
        frame = self.frame_tensors(self.frames[0])
        r_refined, _ = ref.register(*frame, grid, valid, self.cfg["register_iterations"])
        start = self.start_out
        if control:
            start = ranked(*low.register(*frame, grid, valid, self.cfg["register_iterations"]))
            pose, chain = start[1][0], []
            for i in self.cycle[:n_chain]:
                pose = self._track(low, pose, i)
                chain.append(pose)
        out = {"start_" + k: v for k, v in register_numbers(ref, frame, valid, r_refined, *start).items()}
        gaps = []
        for i, pose_in, pose_out in recs:
            if control:
                pose_out = self._track(low, pose_in, i)
            want = self._track(ref, pose_in, i)
            gaps.append([float(x) for x in (*G.pose_gap(pose_out, want), G.add_gap(pose_out, want, self.mesh.pos))])
        pose, chained = r_refined[int(start[0][0])], []
        for i, got in zip(self.cycle, chain):
            pose = self._track(ref, pose, i)
            chained.append(float(G.add_gap(got, pose, self.mesh.pos)))
        dt, dr, add = (np.array(x) for x in zip(*gaps))
        return out | {"track_trans_gap_mm": float(np.median(dt)) * 1e3, "track_rot_gap_deg": float(np.median(dr)),
                      "track_add_mm": float(np.median(add)) * 1e3, "track_add_max_mm": float(add.max()) * 1e3,
                      "chain_add_mm": float(np.median(chained)) * 1e3, "chain_add_max_mm": max(chained) * 1e3}
