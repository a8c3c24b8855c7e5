"""End-to-end walkthrough on a synthetic scene: no datasets, no checkpoints.

Port of examples/synthetic_end_to_end.py on foundationpose_torch:

1. two synthetic objects (a textured bumpy sphere and a colored box);
2. a composite RGB-D sequence of both moving, rendered on `--device`;
3. `FoundationPose.register` of each object on frame 0;
4. both objects tracked with one batched step a frame (`MultiTracker`);
5. ADD-S of every frame against the synthetic ground truth;
6. with --reconstruct, a neural object field trained from the sphere's
   rendered views, and the recovered mesh's extent.

Without checkpoints the scorer runs in depth-alignment mode and the
refiner has zeroed heads (identity refinement): the register still
finds the pose up to the rotation grid and the median-depth z bias.
Pass --refiner_ckpt / --scorer_ckpt (.pth with its config.yml, or .npz)
for the network path.

    python -m foundationpose_torch.examples.synthetic_end_to_end \
        [--device cpu] [--frames 8] [--reconstruct]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402


def make_objects():
    from foundationpose_torch.geometry.icosphere import icosphere
    from foundationpose_torch.meshio import TriMesh, make_box

    rng = np.random.default_rng(0)
    verts, faces = icosphere(3, radius=0.06)
    verts = verts * (1.0 + 0.2 * np.sin(6 * verts[:, 2:3]))
    nrm = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    uv = np.stack([np.arctan2(nrm[:, 1], nrm[:, 0]) / (2 * np.pi) + 0.5,
                   nrm[:, 2] * 0.5 + 0.5], axis=-1).astype(np.float32)
    tex = rng.integers(30, 255, size=(128, 128, 3)).astype(np.uint8)
    sphere = TriMesh(vertices=verts.astype(np.float64), faces=faces.astype(np.int64), uv=uv,
                     texture=tex)
    box = make_box(np.array([0.1, 0.12, 0.16]))
    box.vertex_colors = rng.integers(40, 255, size=(8, 3)).astype(np.uint8)
    return [sphere, box]


def gt_trajectory(n_frames):
    """Ground-truth poses of both objects per frame: a slow drift and turn."""
    import torch

    from foundationpose_torch.geometry import so3_exp_map

    p0 = np.eye(4)
    p0[:3, 3] = [-0.09, 0.0, 0.8]
    p1 = np.eye(4)
    p1[:3, 3] = [0.09, -0.02, 0.9]
    frames = []
    for t in range(n_frames):
        cur = []
        for m, b in enumerate((p0, p1)):
            p = b.copy()
            w = np.array([0.0, 0.02 * t * (1 + m), 0.015 * t], np.float32)
            p[:3, :3] = so3_exp_map(torch.as_tensor(w[None]))[0].numpy() @ b[:3, :3]
            p[:3, 3] = b[:3, 3] + t * np.array([0.004, 0.002 * (-1) ** m, 0.0])
            cur.append(p)
        frames.append(np.stack(cur))
    return frames


def render_frame(meshes, poses, K, H, W, device):
    """The objects composited by depth: (rgb uint8, depth f32, per-object masks)."""
    import torch

    from foundationpose_torch.ops import render_mesh

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    rgb = np.zeros((H, W, 3), np.uint8)
    depth = np.full((H, W), np.inf, np.float32)
    masks = []
    for mesh, pose in zip(meshes, poses):
        if mesh.has_texture:
            uvf = np.stack([mesh.uv[:, 0], 1.0 - mesh.uv[:, 1]], axis=-1)
            kw = dict(uv=t(uvf), tex=t(mesh.texture.astype(np.float32) / 255.0))
        else:
            kw = dict(vertex_color=t(mesh.vertex_colors.astype(np.float32) / 255.0))
        out = render_mesh(t(mesh.vertices), t(mesh.faces, torch.int64), t(pose[None]), t(K),
                          out_hw=(H, W), vnormals=t(mesh.vertex_normals), use_light=True, **kw)
        d0 = out.depth[0].cpu().numpy()
        d = np.where(d0 > 0, d0, np.inf)
        closer = d < depth
        depth = np.where(closer, d, depth)
        rgb = np.where(closer[..., None], (out.color[0].cpu().numpy() * 255).astype(np.uint8), rgb)
        masks.append(out.mask[0].cpu().numpy().astype(bool) & closer)
    return rgb, np.where(np.isinf(depth), 0.0, depth).astype(np.float32), masks


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--reconstruct", action="store_true")
    parser.add_argument("--refiner_ckpt", type=str, default=None)
    parser.add_argument("--scorer_ckpt", type=str, default=None)
    parser.add_argument("--base_width", type=int, default=16,
                        help="net width when no checkpoints are given (64 = reference size)")
    parser.add_argument("--device", type=str, default="cuda",
                        help='"cuda" (default; raises without a card) or "cpu"')
    args = parser.parse_args(argv)

    import torch

    from foundationpose_torch import FoundationPose, MultiTracker
    from foundationpose_torch.models import RefineNetCfg, ScoreNetCfg, init_refine_net
    from foundationpose_torch.pipeline import EstimatorCfg, RefinerCfg, ScorerCfg
    from foundationpose_torch.torch_config import default_device
    from foundationpose_torch.utils.metrics import adds_err

    device = default_device(args.device)
    H, W = 240, 320
    K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1.0]], np.float32)
    meshes = make_objects()
    traj = gt_trajectory(args.frames)

    if args.refiner_ckpt or args.scorer_ckpt:
        cfg = EstimatorCfg()
        refiner = None  # loaded by load_weights below
    else:
        w = args.base_width
        cfg = EstimatorCfg(
            refiner=RefinerCfg(net=RefineNetCfg(base_width=w), compute_dtype="float32"),
            scorer=ScorerCfg(net=ScoreNetCfg(base_width=w), mode="depth"),
            # a coarse rotation grid keeps the walkthrough CPU-friendly;
            # raise toward the defaults (40 views / 60 deg) on the card
            min_n_views=4,
            inplane_step_deg=90.0,
        )
        # zeroed heads: identity refinement (no trained weights); the
        # depth scorer still ranks the rotation grid
        refiner = init_refine_net(cfg.refiner.net, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for head in (refiner.trans_head, refiner.rot_head):
                head[1].weight.zero_()
                head[1].bias.zero_()

    print("== frame 0: register each object")
    rgb0, depth0, masks0 = render_frame(meshes, traj[0], K, H, W, device)
    ests = []
    for m, mesh in enumerate(meshes):
        est = FoundationPose(mesh=mesh, cfg=cfg, refiner_params=refiner, device=device)
        if args.refiner_ckpt or args.scorer_ckpt:
            est.load_weights(args.refiner_ckpt, args.scorer_ckpt)
        pose = est.register(K, rgb0, depth0, masks0[m], iteration=5)
        err = adds_err(pose, traj[0][m], meshes[m].vertices)
        print(f"  object {m}: ADD-S vs gt = {err * 1e3:.1f} mm")
        ests.append(est)

    print(f"== frames 1..{args.frames - 1}: MultiTracker (one batched step a frame)")
    tracker = MultiTracker.from_estimators(ests)
    for t in range(1, args.frames):
        rgb, depth, _ = render_frame(meshes, traj[t], K, H, W, device)
        poses = tracker.track(rgb, depth, K, iteration=2)
        errs = [adds_err(poses[m], traj[t][m], meshes[m].vertices) for m in range(len(meshes))]
        print("  frame %2d: ADD-S = %s mm" % (t, ", ".join(f"{e * 1e3:.1f}" for e in errs)))

    if args.reconstruct:
        print("== neural object field: reconstruct the sphere from views")
        from foundationpose_torch.geometry.icosphere import sample_views_icosphere
        from foundationpose_torch.nerf import NerfCfg, run_neural_object_field

        cam_in_obs = sample_views_icosphere(n_views=4).copy()
        cam_in_obs[:, :3, 3] *= 0.5
        rgbs, depths, masks = [], [], []
        for p in np.linalg.inv(cam_in_obs):
            r, d, ms = render_frame(meshes[:1], p[None], K, H, W, device)
            rgbs.append(r)
            depths.append(d)
            masks.append(ms[0])
        nerf_cfg = NerfCfg(n_step=400, n_rand=512, n_samples=32, n_samples_around_depth=32,
                           log2_hashmap_size=16, finest_res=128)
        rec_mesh, _ = run_neural_object_field(nerf_cfg, K, np.stack(rgbs), np.stack(depths),
                                              np.stack(masks), cam_in_obs, device=device)
        lo, hi = rec_mesh.bounds()
        print(f"  recovered mesh: {len(rec_mesh.vertices)} verts, extent {np.round(hi - lo, 3)} m "
              f"(gt sphere extent ~{np.round(np.ptp(meshes[0].vertices, axis=0), 3)})")

    print("done.")


if __name__ == "__main__":
    main()
