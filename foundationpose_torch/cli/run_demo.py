"""Demo driver: register on frame 0, track the rest of an RGB-D video.

Port of foundationpose_tpu/cli/run_demo.py (the reference's
run_demo.py:15-78) for YCBInEOAT-format scene directories (rgb/ depth/
masks/ cam_K.txt):

    python -m foundationpose_torch.cli.run_demo --mesh_file obj.obj \
        --test_scene_dir scene/ [--device cpu]

Frames after the first are tracked with `track_one_async` and fetched in
batches of 4 with `fetch_track_results` (one transfer a batch) while up
to 8 frames are in flight; the poses are those of sequential `track_one`
calls. Each pose is written to <debug_dir>/ob_in_cam/<id>.txt and, with
--debug >= 1, a box-and-axes drawing to <debug_dir>/track_vis/<id>.png,
through imageio where it is installed and cv2 otherwise (the readers
need imageio for the color frames).

With no trained checkpoints the scorer falls back to the classical
depth-alignment mode; pass --refiner_ckpt / --scorer_ckpt to use
FoundationPose weights (.pth with its config.yml, or .npz).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from collections import deque

import numpy as np

from ..utils.vis import write_png as _write_png


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


def main(argv=None):
    parser = argparse.ArgumentParser()
    code_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--mesh_file", type=str, required=True)
    parser.add_argument("--test_scene_dir", type=str, required=True)
    parser.add_argument("--est_refine_iter", type=int, default=5)
    parser.add_argument("--track_refine_iter", type=int, default=2)
    parser.add_argument("--fast_register", action="store_true",
                        help="funneled-register preset (prune after 2 iterations, keep 64)")
    parser.add_argument("--refiner_ckpt", type=str, default=None)
    parser.add_argument("--scorer_ckpt", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help='"cuda" (default; raises without a card) or "cpu"')
    parser.add_argument("--debug", type=int, default=1)
    parser.add_argument("--debug_dir", type=str, default=f"{code_dir}/debug")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")

    from ..datasets import YcbineoatReader
    from ..meshio import load_mesh
    from ..pipeline import fetch_track_results
    from ..utils.vis import draw_posed_3d_box, draw_xyz_axis

    mesh = load_mesh(args.mesh_file)
    os.makedirs(f"{args.debug_dir}/ob_in_cam", exist_ok=True)
    os.makedirs(f"{args.debug_dir}/track_vis", exist_ok=True)

    est = build_estimator(mesh, args)
    reader = YcbineoatReader(video_dir=args.test_scene_dir, shorter_side=None, zfar=np.inf)
    bbox = mesh.bounds() - mesh.bounds().mean(axis=0, keepdims=True)

    def finish_frame(i, pose, color):
        np.savetxt(f"{args.debug_dir}/ob_in_cam/{reader.id_strs[i]}.txt", pose.reshape(4, 4))
        if args.debug >= 1:
            center_pose = pose @ np.linalg.inv(est.get_tf_to_centered_mesh())
            vis = draw_posed_3d_box(reader.K, img=color.copy(), ob_in_cam=center_pose, bbox=bbox)
            vis = draw_xyz_axis(vis, ob_in_cam=center_pose, scale=0.1, K=reader.K, thickness=3,
                                transparency=0, is_input_rgb=True)
            _write_png(f"{args.debug_dir}/track_vis/{reader.id_strs[i]}.png", vis)
        logging.info("frame %s done", reader.id_strs[i])

    def drain(n):
        batch = [pending.popleft() for _ in range(min(n, len(pending)))]
        for (j, _f, c), p in zip(batch, fetch_track_results([f for _, f, _ in batch])):
            finish_frame(j, p, c)

    pending: deque = deque()  # (frame index, TrackResult, color)
    for i in range(len(reader.color_files)):
        color = reader.get_color(i)
        depth = reader.get_depth(i)
        if i == 0:
            pose = est.register(K=reader.K, rgb=color, depth=depth,
                                ob_mask=reader.get_mask(0).astype(bool),
                                iteration=args.est_refine_iter)
            finish_frame(0, pose, color)
            continue
        pending.append((i, est.track_one_async(rgb=color, depth=depth, K=reader.K,
                                               iteration=args.track_refine_iter), color))
        if len(pending) >= 8:  # stay 4-8 frames ahead of the device
            drain(4)
    while pending:
        drain(4)


if __name__ == "__main__":
    main()
