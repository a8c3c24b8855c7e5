"""Model-free reconstruction entry point (reference bundlesdf/run_nerf.py:
49-115):

    python -m foundationpose_torch.cli.run_nerf --ref_view_dir r/ [--device cpu]

Port of foundationpose_tpu/cli/run_nerf.py with the same flags and
--device (default "cuda": the field trains on the card unless asked for
the CPU; without a card and without --device cpu it raises). Reads a
reference-view directory (rgb/*.png, depth_enhanced/ or depth/*.png in
uint16 millimetres, masks/*.png, cam_in_ob/*.txt, K.txt; or one such
directory per ob_* subdirectory), trains the neural object field and
writes model/model.obj in metres. Color is read with imageio where it is
installed and otherwise with cv2; depth and masks with cv2, imported
when a view is read.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import logging
import os

import numpy as np


def load_ref_views(base_dir):
    """-> (rgbs (N, H, W, 3) uint8, depths (N, H, W) metres, masks (N, H, W)
    uint8, cam_in_obs (N, 4, 4), K (3, 3))."""
    import cv2

    from ..utils.vis import read_rgb

    color_files = sorted(glob.glob(f"{base_dir}/rgb/*.png"))
    K = np.loadtxt(f"{base_dir}/K.txt").reshape(3, 3)
    rgbs, depths, masks, cam_in_obs = [], [], [], []
    for f in color_files:
        rgbs.append(read_rgb(f))
        depth_file = f.replace("rgb", "depth_enhanced")
        if not os.path.exists(depth_file):
            depth_file = f.replace("rgb", "depth")
        depths.append(cv2.imread(depth_file, -1) / 1e3)
        masks.append((cv2.imread(f.replace("rgb", "masks"), -1) > 0).astype(np.uint8))
        cam_in_obs.append(np.loadtxt(f.replace("rgb", "cam_in_ob").replace(".png", ".txt")).reshape(4, 4))
    return np.asarray(rgbs), np.asarray(depths), np.asarray(masks), np.asarray(cam_in_obs), K


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ref_view_dir", type=str, required=True)
    parser.add_argument("--dataset", type=str, default="ycbv", choices=["ycbv", "linemod"])
    parser.add_argument("--n_step", type=int, default=None)
    parser.add_argument("--preset", type=str, default="parity", choices=["parity", "fast"],
                        help="'fast' keeps about a quarter of the points a step (TPU_FAST_OVERRIDES)")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--artifact_dir", type=str, default=None,
                        help="periodic eval image/mesh dumps during training")
    parser.add_argument("--i_img", type=int, default=500)
    parser.add_argument("--i_mesh", type=int, default=500)
    parser.add_argument("--device", type=str, default="cuda",
                        help='"cuda" (default; raises without a card) or "cpu"')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")

    from ..nerf import LINEMOD_OVERRIDES, TPU_FAST_OVERRIDES, NerfCfg, run_neural_object_field
    from ..torch_config import default_device

    default_device(args.device)  # no card and no --device cpu: raise before reading anything

    cfg = NerfCfg()
    if args.dataset == "linemod":
        cfg = dataclasses.replace(cfg, **LINEMOD_OVERRIDES)
    if args.preset == "fast":
        cfg = dataclasses.replace(cfg, **TPU_FAST_OVERRIDES)
    if args.n_step is not None:
        cfg = dataclasses.replace(cfg, n_step=args.n_step)

    ob_dirs = sorted(glob.glob(f"{args.ref_view_dir}/ob_*")) or [args.ref_view_dir]
    for ob_dir in ob_dirs:
        rgbs, depths, masks, cam_in_obs, K = load_ref_views(ob_dir)
        mesh, _runner = run_neural_object_field(
            cfg, K, rgbs, depths, masks, cam_in_obs,
            artifact_dir=args.artifact_dir, i_img=args.i_img, i_mesh=args.i_mesh, device=args.device,
        )
        out_dir = args.out_dir or f"{ob_dir}/model"
        os.makedirs(out_dir, exist_ok=True)
        mesh.export(f"{out_dir}/model.obj")
        logging.info("mesh -> %s/model.obj (%d verts)", out_dir, len(mesh.vertices))


if __name__ == "__main__":
    main()
