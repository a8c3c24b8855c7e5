"""The port's demo drivers on the CPU: run_demo end to end on the
fabricated YCBInEOAT scene of tests/test_cli.py (register on frame 0,
pipelined tracking with batched fetches, one ob_in_cam/<id>.txt and one
drawing per frame), run_multi_demo on the same scene, and their argument
checks.

The driver's poses must match a sequential register + track_one run of
an estimator built the same way within 1e-3, the bound of the JAX
package's own test: the pipelined windows lag the sequential ones, and a
shifted principal point rounds otherwise (live random heads).
"""
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from foundationpose_tpu.meshio import export_ply  # numpy only: writes the PLY file
from foundationpose_torch.meshio import make_box
from foundationpose_torch.models.networks import (
    RefineNetCfg, ScoreNetCfg, init_refine_net, init_score_net)
from foundationpose_torch.ops.rasterizer import render_mesh_brute
from foundationpose_torch.pipeline import EstimatorCfg, FoundationPose, RefinerCfg, ScorerCfg
from test_torch_tracking import one_torch_thread  # noqa: F401  (fixture)

H, W = 240, 320
K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1.0]])
N_FRAMES = 8


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """tests/test_cli.py's scene: a colored box moving 2 mm a frame at
    1.25 m, depth in millimeter PNGs, and a seeded refiner checkpoint
    (base width 4, 32x32 crops, f32, delta heads scaled by 0.1) written by
    the port's save_weights."""
    root = tmp_path_factory.mktemp("demo")
    box = make_box(np.array([0.12, 0.16, 0.2]))
    box.vertex_colors = np.random.default_rng(0).integers(40, 255, size=(8, 3)).astype(np.uint8)
    scene = root / "scene"
    for sub in ("rgb", "depth", "masks"):
        (scene / sub).mkdir(parents=True)
    np.savetxt(scene / "cam_K.txt", K)
    for i in range(N_FRAMES):
        gt = np.eye(4, dtype=np.float32)
        gt[:3, 3] = [0.02 + 0.002 * i, -0.01, 1.25]
        out = render_mesh_brute(
            torch.as_tensor(box.vertices, dtype=torch.float32), torch.as_tensor(box.faces),
            torch.as_tensor(gt[None]), torch.as_tensor(K, dtype=torch.float32), out_hw=(H, W),
            vertex_color=torch.as_tensor(box.vertex_colors / 255.0, dtype=torch.float32),
            vnormals=torch.as_tensor(box.vertex_normals, dtype=torch.float32),
        )
        imageio.imwrite(scene / "rgb" / f"{i:05d}.png", (out.color[0].numpy() * 255).astype(np.uint8))
        imageio.imwrite(scene / "depth" / f"{i:05d}.png",
                        np.round(out.depth[0].numpy() * 1000).astype(np.uint16))
        imageio.imwrite(scene / "masks" / f"{i:05d}.png", (out.mask[0].numpy() * 255).astype(np.uint8))
    mesh_file = str(root / "box.ply")
    export_ply(box, mesh_file)
    rcfg = RefinerCfg(net=RefineNetCfg(base_width=4), compute_dtype="float32", input_res=32)
    ckpt = str(root / "refiner.npz")
    refiner = init_refine_net(rcfg.net, torch.Generator().manual_seed(3))
    with torch.no_grad():  # live deltas about a tenth of a random head's
        for head in (refiner.trans_head, refiner.rot_head):
            head[1].weight.mul_(0.1)
            head[1].bias.mul_(0.1)
    # and a test-width network scorer (32x32 crops: the default 160x160
    # would make each CPU register ~10x dearer)
    scfg = ScorerCfg(net=ScoreNetCfg(base_width=4), compute_dtype="float32", input_res=32)
    FoundationPose(mesh=box, cfg=EstimatorCfg(refiner=rcfg, scorer=scfg), refiner_params=refiner,
                   scorer_params=init_score_net(scfg.net, torch.Generator().manual_seed(4)),
                   device="cpu").save_weights(refiner_path=ckpt, scorer_path=ckpt + ".scorer.npz")
    return root, scene, mesh_file, ckpt


@pytest.fixture(scope="module")
def sequential(scene):
    """The same frames through blocking calls of an estimator built as the
    driver builds it: (poses, estimator)."""
    import argparse

    from foundationpose_torch.cli.run_demo import build_estimator
    from foundationpose_torch.meshio import load_mesh

    _root, scene_dir, mesh_file, ckpt = scene
    est = build_estimator(load_mesh(mesh_file), argparse.Namespace(
        refiner_ckpt=ckpt, scorer_ckpt=ckpt + ".scorer.npz", fast_register=False, device="cpu"))
    frames = []
    for i in range(N_FRAMES):
        d = imageio.imread(scene_dir / "depth" / f"{i:05d}.png") / 1e3
        d[d < 0.001] = 0
        frames.append((imageio.imread(scene_dir / "rgb" / f"{i:05d}.png")[..., :3], d))
    mask0 = imageio.imread(scene_dir / "masks" / "00000.png") > 0
    want = [est.register(K, frames[0][0], frames[0][1], mask0, iteration=1)]
    want += [est.track_one(r, d, K, iteration=1) for r, d in frames[1:]]
    return want, est


def test_run_demo_end_to_end_matches_sequential(scene, sequential):
    from foundationpose_torch.cli.run_demo import main

    root, scene_dir, mesh_file, ckpt = scene
    debug_dir = root / "debug"
    main(["--mesh_file", mesh_file, "--test_scene_dir", str(scene_dir), "--refiner_ckpt", ckpt,
          "--scorer_ckpt", ckpt + ".scorer.npz", "--est_refine_iter", "1", "--track_refine_iter", "1", "--device", "cpu",
          "--debug", "1", "--debug_dir", str(debug_dir)])
    want, est = sequential
    assert est.has_refiner and est.cfg.refiner.input_res == 32 and est.cfg.track_roi
    assert est.cfg.scorer.mode == "network" and est.cfg.scorer.input_res == 32
    assert est._track_roi_window(K, H, W) is not None  # the windowed path ran
    for i in range(N_FRAMES):
        got = np.loadtxt(debug_dir / "ob_in_cam" / f"{i:05d}.txt")
        assert got.shape == (4, 4) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want[i], atol=1e-3, rtol=0)
        vis = imageio.imread(debug_dir / "track_vis" / f"{i:05d}.png")
        assert vis.shape == (H, W, 3)
    assert np.abs(want[-1] - want[1]).max() > 1e-4  # the refiner moved the poses
    assert abs(np.loadtxt(debug_dir / "ob_in_cam" / "00000.txt")[2, 3] - 1.25) < 0.5


def test_run_demo_defaults_to_the_card(scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from foundationpose_torch.cli.run_demo import main

    root, scene_dir, mesh_file, _ckpt = scene
    with pytest.raises(RuntimeError):
        main(["--mesh_file", mesh_file, "--test_scene_dir", str(scene_dir),
              "--debug_dir", str(root / "debug_card")])


def test_visualisation_written_with_cv2_without_imageio(tmp_path, monkeypatch):
    from foundationpose_torch.cli.run_demo import _write_png

    rgb = np.zeros((8, 10, 3), np.uint8)
    rgb[..., 0] = 200  # red
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    _write_png(str(tmp_path / "v.png"), rgb)
    monkeypatch.undo()
    np.testing.assert_array_equal(imageio.imread(tmp_path / "v.png"), rgb)


def test_run_multi_demo_end_to_end(scene, sequential):
    """Two copies of the box from the same frame-0 mask: one MultiTracker
    step a frame gives both the same poses, on the first register's path."""
    from foundationpose_torch.cli.run_multi_demo import main

    root, scene_dir, mesh_file, ckpt = scene
    debug_dir = root / "debug_multi"
    mask = str(scene_dir / "masks" / "00000.png")
    main(["--mesh_files", f"{mesh_file},{mesh_file}", "--mask_files", f"{mask},{mask}",
          "--test_scene_dir", str(scene_dir), "--refiner_ckpt", ckpt,
          "--scorer_ckpt", ckpt + ".scorer.npz", "--est_refine_iter", "1",
          "--track_refine_iter", "1", "--device", "cpu", "--debug_dir", str(debug_dir)])
    want = sequential[0]
    for i in range(N_FRAMES):
        a = np.loadtxt(debug_dir / "ob_in_cam_0" / f"{i:05d}.txt")
        b = np.loadtxt(debug_dir / "ob_in_cam_1" / f"{i:05d}.txt")
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, want[i], atol=1e-3, rtol=0)


def test_drawing_matches_jax():
    from foundationpose_tpu.utils import vis as jvis
    from foundationpose_torch.utils import vis as tvis

    img = np.random.default_rng(2).integers(0, 255, (H, W, 3)).astype(np.uint8)
    pose = np.eye(4)
    pose[:3, 3] = [0.02, -0.01, 0.9]
    bbox = np.array([[-0.06, -0.08, -0.1], [0.06, 0.08, 0.1]])
    for mod in (jvis, tvis):
        box = mod.draw_posed_3d_box(K, img=img.copy(), ob_in_cam=pose, bbox=bbox)
        out = mod.draw_xyz_axis(box, ob_in_cam=pose, scale=0.1, K=K, thickness=3, is_input_rgb=True)
        depth = mod.depth_to_vis(np.linspace(0, 2, H * W).reshape(H, W))
        if mod is jvis:
            want = (out, depth)
    np.testing.assert_array_equal(out, want[0])
    np.testing.assert_array_equal(depth, want[1])
    assert (out != img).any()


def test_run_multi_demo_rejects_mismatched_lists():
    from foundationpose_torch.cli.run_multi_demo import main

    with pytest.raises(SystemExit):
        main(["--mesh_files", "a.obj,b.obj", "--mask_files", "a.png", "--test_scene_dir", "x"])
