"""Estimator construction for the command-line drivers.

Port of `build_estimator` of foundationpose_tpu/cli/run_demo.py, the
function cli/run_bop.py builds its estimator with. The demo driver itself
(register on frame 0, pipelined `track_one_async` over the video, pose
drawing from utils/vis.py) is not ported yet: it needs the asynchronous
tracking and the drawing helpers, which this package does not have.
"""
from __future__ import annotations

import dataclasses


def build_estimator(mesh, args):
    """A FoundationPose on `args.device` (default "cuda"), with each
    checkpoint's shipped config ingested (embedded `.npz` meta or the
    sidecar config.yml of a `.pth`) so the pipeline runs under the
    settings the weights were trained for (predict_pose_refine.py:102-131,
    predict_score.py:126-143); `args.fast_register` applies the
    funneled-register preset."""
    from ..models.loading import load_estimator_checkpoint
    from ..pipeline import EstimatorCfg, FoundationPose

    cfg = EstimatorCfg()
    refiner_sd = scorer_sd = None
    if args.refiner_ckpt:
        refiner_sd, rcfg, zfar = load_estimator_checkpoint(
            args.refiner_ckpt, "refiner", base=cfg.refiner
        )
        cfg = dataclasses.replace(cfg, refiner=rcfg)
        if zfar is not None:
            cfg = dataclasses.replace(cfg, zfar=zfar)
    if args.scorer_ckpt:
        scorer_sd, scfg, _ = load_estimator_checkpoint(args.scorer_ckpt, "scorer", base=cfg.scorer)
        cfg = dataclasses.replace(cfg, scorer=scfg)
    if getattr(args, "fast_register", False):
        cfg = cfg.fast_register()
    return FoundationPose(
        mesh=mesh, cfg=cfg, refiner_params=refiner_sd, scorer_params=scorer_sd,
        device=getattr(args, "device", "cuda"),
    )
