"""Multi-object demo driver: register each object on frame 0, then track
all of them with one MultiTracker step per frame.

Port of foundationpose_tpu/cli/run_multi_demo.py (the reference has no
multi-object driver: its run_demo.py:15-78 tracks one object):

    python -m foundationpose_torch.cli.run_multi_demo \
        --mesh_files obj1.obj,obj2.obj --test_scene_dir scene/ \
        --mask_files frame0_mask_obj1.png,frame0_mask_obj2.png [--device cpu]

The scene dir is YCBInEOAT-format (rgb/ depth/ cam_K.txt); the per-object
frame-0 masks come from --mask_files (the scene's own masks/ dir holds
one object). Poses are written to <debug_dir>/ob_in_cam_<m>/.
"""
from __future__ import annotations

import argparse
import logging
import os
from collections import deque

import numpy as np

from .run_demo import build_estimator


def main(argv=None):
    parser = argparse.ArgumentParser()
    code_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--mesh_files", type=str, required=True,
                        help="comma-separated mesh files, one per object")
    parser.add_argument("--test_scene_dir", type=str, required=True)
    parser.add_argument("--mask_files", type=str, required=True,
                        help="comma-separated frame-0 mask images, one per object")
    parser.add_argument("--est_refine_iter", type=int, default=5)
    parser.add_argument("--track_refine_iter", type=int, default=2)
    parser.add_argument("--refiner_ckpt", type=str, default=None)
    parser.add_argument("--scorer_ckpt", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help='"cuda" (default; raises without a card) or "cpu"')
    parser.add_argument("--debug", type=int, default=1)
    parser.add_argument("--debug_dir", type=str, default=f"{code_dir}/debug")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")

    mesh_files = [p for p in args.mesh_files.split(",") if p]
    mask_files = [p for p in args.mask_files.split(",") if p]
    if len(mesh_files) != len(mask_files):
        raise SystemExit(
            f"--mesh_files ({len(mesh_files)}) and --mask_files "
            f"({len(mask_files)}) must list one entry per object"
        )

    from ..datasets import YcbineoatReader
    from ..datasets.readers import _imread
    from ..meshio import load_mesh
    from ..pipeline import MultiTracker

    reader = YcbineoatReader(video_dir=args.test_scene_dir, shorter_side=None, zfar=np.inf)
    color0 = reader.get_color(0)
    depth0 = reader.get_depth(0)

    # Frame 0: one register per object (the hypothesis sweep needs the
    # full estimator); every later frame is one MultiTracker step.
    ests = []
    for mesh_file, mask_file in zip(mesh_files, mask_files):
        est = build_estimator(load_mesh(mesh_file), args)
        mask = np.asarray(_imread(mask_file))
        if mask.ndim == 3:
            mask = mask[..., 2]  # cv2 reads BGR(A): the red channel, imageio's first
        est.register(K=reader.K, rgb=color0, depth=depth0, ob_mask=mask.astype(bool),
                     iteration=args.est_refine_iter)
        ests.append(est)

    tracker = MultiTracker.from_estimators(ests)
    M = tracker.n_objects
    for m in range(M):
        os.makedirs(f"{args.debug_dir}/ob_in_cam_{m}", exist_ok=True)

    def finish_frame(i, poses):
        for m in range(M):
            np.savetxt(f"{args.debug_dir}/ob_in_cam_{m}/{reader.id_strs[i]}.txt",
                       poses[m].reshape(4, 4))
        logging.info("frame %s done (%d objects)", reader.id_strs[i], M)

    finish_frame(0, np.stack([e._pose_hint @ e.get_tf_to_centered_mesh() for e in ests]))
    pending: deque = deque()
    for i in range(1, len(reader.color_files)):
        pending.append((i, tracker.track_async(reader.get_color(i), reader.get_depth(i), reader.K,
                                               iteration=args.track_refine_iter)))
        if len(pending) > 3:
            j, fut = pending.popleft()
            finish_frame(j, fut.result())
    while pending:
        j, fut = pending.popleft()
        finish_frame(j, fut.result())


if __name__ == "__main__":
    main()
