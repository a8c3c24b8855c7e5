"""BOP benchmark driver: per-object registration over dataset scenes.

Unifies the reference's run_linemod.py / run_ycb_video.py (their
structure is identical up to the reader; run_linemod.py:90-133,
run_ycb_video.py:82-130): for each object in each scene, register every
(key)frame and dump per-frame 4x4 poses to YAML. Unlike the reference,
this driver also ships the scoring pass (--score) computing ADD /
ADD-S AUC against GT, which the reference left out of the repo.

Port of foundationpose_tpu/cli/run_bop.py, with the same flags and
--device (default "cuda": the estimator runs on the card unless asked
for the CPU; without a card and without --device cpu it raises).
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def nest_set(d, keys, value):
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def run_dataset(args):
    import yaml

    from ..datasets import get_bop_reader, get_bop_video_dirs
    from .run_demo import build_estimator

    video_dirs = get_bop_video_dirs(args.dataset)
    if args.max_videos:
        video_dirs = video_dirs[: args.max_videos]
    # Embarrassingly-parallel fan-out across hosts (SURVEY.md §2.9): each
    # worker takes every num_shards-th scene; results merge by YAML cat.
    if args.num_shards > 1:
        video_dirs = video_dirs[args.shard_index :: args.num_shards]
    res = {}
    est = None
    for video_dir in video_dirs:
        reader = get_bop_reader(video_dir, zfar=np.inf)
        video_id = reader.get_video_id()
        for ob_id in reader.ob_ids:
            if args.use_reconstructed_mesh:
                mesh = reader.get_reconstructed_mesh(
                    ob_id, ref_view_dir=args.ref_view_dir
                )
            else:
                mesh = reader.get_gt_mesh(ob_id)
            symmetry_tfs = reader.symmetry_tfs[ob_id]
            if est is None:
                est = build_estimator(mesh, args)
            est.reset_object(mesh=mesh, symmetry_tfs=symmetry_tfs)
            est.make_rotation_grid(
                min_n_views=args.min_n_views, inplane_step=args.inplane_step
            )

            for i in range(len(reader.color_files)):
                if hasattr(reader, "is_keyframe") and not reader.is_keyframe(i):
                    continue
                if ob_id not in reader.get_instance_ids_in_image(i):
                    continue
                color = reader.get_color(i)
                depth = reader.get_depth(i)
                ob_mask = reader.get_mask(i, ob_id, type=args.detect_type)
                if ob_mask is None or ob_mask.sum() == 0:
                    logging.info("no mask for ob %d frame %d", ob_id, i)
                    continue
                K = reader.get_K(i)
                est.gt_pose = reader.get_gt_pose(i, ob_id, mask=ob_mask)
                pose = est.register(
                    K=K, rgb=color, depth=depth, ob_mask=ob_mask,
                    iteration=args.est_refine_iter,
                )
                nest_set(
                    res,
                    [args.dataset, str(video_id), str(ob_id), reader.id_strs[i]],
                    pose.reshape(4, 4).tolist(),
                )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as ff:
        yaml.safe_dump(res, ff)
    logging.info("results -> %s", args.out)
    return res


def score_results(args):
    """ADD / ADD-S AUC scoring harness (reference shipped the metric
    helpers at Utils.py:232-266 but no driver)."""
    import yaml

    from ..datasets import get_bop_reader, get_bop_video_dirs
    from ..utils.metrics import add_err, adds_err, compute_auc

    with open(args.out) as ff:
        res = yaml.safe_load(ff)
    adds = []
    add = []
    video_dirs = {str(get_bop_reader(v).get_video_id()): v for v in get_bop_video_dirs(args.dataset)}
    for video_id, obs in res[args.dataset].items():
        reader = get_bop_reader(video_dirs[video_id])
        id_to_index = {s: i for i, s in enumerate(reader.id_strs)}
        for ob_id, frames in obs.items():
            mesh = reader.get_gt_mesh(int(ob_id))
            pts = mesh.vertices
            if len(pts) > 2000:
                pts = pts[:: len(pts) // 2000]
            for id_str, pose in frames.items():
                gt = reader.get_gt_pose(id_to_index[id_str], int(ob_id))
                pose = np.asarray(pose)
                add.append(add_err(pose, gt, pts))
                adds.append(adds_err(pose, gt, pts))
    out = {
        "ADD_AUC": compute_auc(add),
        "ADDS_AUC": compute_auc(adds),
        "n": len(add),
    }
    print(out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="ycbv",
                        choices=["ycbv", "lmo", "lm", "tless", "hb", "tudl", "icbin", "itodd"])
    parser.add_argument("--out", type=str, default="bop_res.yml")
    parser.add_argument("--est_refine_iter", type=int, default=5)
    parser.add_argument("--fast_register", action="store_true",
                        help="funneled-register preset (prune after 2 "
                        "iterations, keep 64)")
    parser.add_argument("--min_n_views", type=int, default=40,
                        help="rotation-grid density (reference: 40)")
    parser.add_argument("--inplane_step", type=int, default=60,
                        help="in-plane rotation step deg (reference: 60)")
    parser.add_argument("--use_reconstructed_mesh", type=int, default=0)
    parser.add_argument("--ref_view_dir", type=str, default=None)
    parser.add_argument("--detect_type", type=str, default="mask_visib")
    parser.add_argument("--max_videos", type=int, default=0)
    parser.add_argument("--num_shards", type=int, default=1,
                        help="split scenes across hosts (with --shard_index)")
    parser.add_argument("--shard_index", type=int, default=0)
    parser.add_argument("--refiner_ckpt", type=str, default=None)
    parser.add_argument("--scorer_ckpt", type=str, default=None)
    parser.add_argument("--score", action="store_true", help="score an existing result file")
    # >= 2: each register's crop canvases (FoundationPose's debug dumps)
    parser.add_argument("--debug", type=int, default=0)
    parser.add_argument("--debug_dir", type=str, default="debug")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the estimator runs: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")
    if args.score:
        return score_results(args)
    return run_dataset(args)


if __name__ == "__main__":
    main()
