"""The port's MultiTracker against foundationpose_tpu's and against M
single-object trackers of the port, on the scene of tests/test_multi.py
(a box and a ball, one composite 240x320 frame) at test width (32x32
crops, f32).

Tolerances: pack bytes exact; poses 1e-4 against the JAX MultiTracker
and against M single trackers (one batched forward against M forwards
of one); pipelined against sequential and a recovered frame against
full-frame tracking bit-equal (the same operations). Windowed against
full-frame tracking: ROI_GAP. The window's shifted principal point
rounds the crop transform otherwise, a nearest-sampled XYZ pixel can
flip, and the live random heads pass that on: the JAX MultiTracker
shows the same gap (1.1e-3 at these weights), and the port's windowed
poses match the JAX package's windowed poses to 1e-4.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.pipeline import MultiTracker as JMulti
from foundationpose_tpu.pipeline.multi import pack_multi_track_frame as j_pack_multi
from foundationpose_torch.geometry.icosphere import icosphere
from foundationpose_torch.meshio import TriMesh
from foundationpose_torch.models import networks as tnet
from foundationpose_torch.models.convert import params_from_jax
from foundationpose_torch.ops.rasterizer import render_mesh_brute
from foundationpose_torch.pipeline import FoundationPose as TPose
from foundationpose_torch.pipeline import MultiTracker
from foundationpose_torch.pipeline.multi import pack_multi_track_frame
from test_torch_pipeline import _box, _cfgs
from test_torch_tracking import H, K, UPLOADS, W, _weights, one_torch_thread  # noqa: F401

POSES = [(-0.08, 0.01, 0.9), (0.10, -0.02, 0.8)]


def _meshes():
    rng = np.random.default_rng(3)
    box = _box()
    v, f = icosphere(2, radius=0.07)
    ball = TriMesh(vertices=v.astype(np.float64), faces=f.astype(np.int64),
                   vertex_colors=rng.integers(40, 255, size=(len(v), 3)).astype(np.uint8))
    return [box, ball]


def _poses():
    out = []
    for t in POSES:
        p = np.eye(4)
        p[:3, 3] = t
        out.append(p)
    return np.stack(out)


def _composite(meshes, poses):
    """All objects z-merged into one RGB-D frame by the port's plain
    rasterizer: numpy (rgb u8, depth f32)."""
    rgb = np.zeros((H, W, 3), np.uint8)
    depth = np.full((H, W), np.inf, np.float32)
    for mesh, pose in zip(meshes, poses):
        out = render_mesh_brute(
            torch.as_tensor(mesh.vertices, dtype=torch.float32), torch.as_tensor(mesh.faces),
            torch.as_tensor(pose[None], dtype=torch.float32), torch.as_tensor(K), out_hw=(H, W),
            vertex_color=torch.as_tensor(mesh.vertex_colors / 255.0, dtype=torch.float32),
            vnormals=torch.as_tensor(mesh.vertex_normals, dtype=torch.float32),
        )
        d = np.where(out.mask[0].numpy(), out.depth[0].numpy(), np.inf)
        closer = d < depth
        depth = np.where(closer, d, depth)
        rgb = np.where(closer[..., None], (out.color[0].numpy() * 255).astype(np.uint8), rgb)
    return rgb, np.where(np.isinf(depth), 0.0, depth).astype(np.float32)


def _cfg_pair(**over):
    """(JAX, port) configs: test width, f32, full-frame packed tracking
    unless overridden."""
    jc, tc = _cfgs("depth")
    kw = {**dict.fromkeys(UPLOADS, True), "track_roi": False, **over}
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _refiner(rp, cfg):
    net = tnet.RefineNet(cfg.refiner.net)
    net.load_state_dict(params_from_jax(rp, net.cfg))
    return net.eval()


ROI = {"track_roi": True, "track_roi_margin": 1.2}  # 1.8 disengages in a 240-px frame
ROI_GAP = 2e-3


@pytest.fixture(scope="module")
def scene():
    meshes = _meshes()
    rgb, depth = _composite(meshes, _poses())
    rp, _sp = _weights(0.2, seed=7)  # random, non-zero heads: the full delta path
    return meshes, rgb, depth, rp


def _port_tracker(meshes, tc, rp):
    t = MultiTracker(meshes=meshes, cfg=tc, refiner_params=_refiner(rp, tc), device="cpu")
    t.set_poses(_poses())
    return t


def _trackers(scene, **over):
    meshes, _rgb, _depth, rp = scene
    jc, tc = _cfg_pair(**over)
    j = JMulti(meshes=meshes, cfg=jc, refiner_params=jax.tree.map(jnp.asarray, rp))
    j.set_poses(_poses())
    return j, _port_tracker(meshes, tc, rp)


def test_pack_multi_track_frame_bytes_equal_jax():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, size=(300, 700, 3), dtype=np.uint8)
    depth = rng.uniform(0, 16, size=(300, 700)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = np.nan
    x0s, y0s = [0, 300, 636], [0, 236, 200]  # offsets past one byte
    want = j_pack_multi(rgb, depth, x0s, y0s, 64)
    got = pack_multi_track_frame(rgb, depth, x0s, y0s, 64)
    assert got.tobytes() == want.tobytes()
    staged = np.zeros(got.size + 5, np.uint8)
    assert pack_multi_track_frame(rgb, depth, x0s, y0s, 64, out=staged).tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", ["full", "roi"])
def test_multi_matches_jax(scene, mode):
    _meshes_, rgb, depth, _rp = scene
    j, t = _trackers(scene, **(ROI if mode == "roi" else {}))
    if mode == "roi":
        assert t._roi_windows(K, H, W) == j._roi_windows(K, H, W) is not None
    for _ in range(2):
        pj = j.track(rgb, depth, K, iteration=2)
        pt = t.track(rgb, depth, K, iteration=2)
        assert pt.shape == (2, 4, 4)
        np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    assert np.abs(pt - _poses()).max() > 1e-3  # the heads moved the poses
    assert t.track_stats == {"frames": 2, "roi_recoveries": 0, "chain_repairs": 0}


@pytest.mark.parametrize("mode", ["full", "roi"])
def test_multi_matches_single_trackers(scene, mode):
    """One MultiTracker step against each object's own FoundationPose
    tracker (built through from_estimators from them)."""
    meshes, rgb, depth, rp = scene
    _jc, tc = _cfg_pair(**(ROI if mode == "roi" else {}))
    refiner = _refiner(rp, tc)

    def estimators():
        ests = []
        for mesh, pose in zip(meshes, _poses()):
            e = TPose(mesh=mesh, cfg=tc, refiner_params=refiner, device="cpu")
            e.pose_last = torch.as_tensor(pose @ np.linalg.inv(e.get_tf_to_centered_mesh()),
                                          dtype=torch.float32)
            e._pose_hint = e.pose_last.numpy().astype(np.float64)
            ests.append(e)
        return ests

    singles = np.stack([e.track_one(rgb, depth, K, iteration=2) for e in estimators()])
    tracker = MultiTracker.from_estimators(estimators())
    assert tracker.refiner is refiner and tracker.n_objects == 2
    multi = tracker.track(rgb, depth, K, iteration=2)
    # windowed: each single tracker sizes its own window, the MultiTracker
    # one size for all
    np.testing.assert_allclose(multi, singles, atol=ROI_GAP if mode == "roi" else 1e-4, rtol=0)


def test_zero_iterations_passthrough(scene):
    meshes, rgb, depth, _rp = scene
    tracker = MultiTracker(meshes=meshes, cfg=_cfg_pair()[1], device="cpu")  # no weights
    assert not tracker.has_refiner
    tracker.set_poses(_poses())
    np.testing.assert_allclose(tracker.track(rgb, depth, K, iteration=2), _poses(), atol=1e-5)


def test_async_pipelined_matches_sequential(scene):
    _meshes_, rgb, depth, _rp = scene
    a, b = _trackers(scene)[1], _trackers(scene)[1]
    seq = [a.track(rgb, depth, K, iteration=1) for _ in range(3)]
    futs = [b.track_async(rgb, depth, K, iteration=1) for _ in range(3)]
    np.testing.assert_array_equal(np.stack([f.result() for f in futs]), np.stack(seq))
    assert np.abs(seq[-1] - seq[0]).max() > 1e-4


def test_set_poses_shape_check(scene):
    meshes, rgb, depth, rp = scene
    tc = _cfg_pair()[1]
    tracker = MultiTracker(meshes=meshes, cfg=tc, refiner_params=_refiner(rp, tc), device="cpu")
    with pytest.raises(ValueError):
        tracker.set_poses(np.eye(4)[None])
    with pytest.raises(RuntimeError):
        MultiTracker(meshes=meshes, cfg=tc, device="cpu").track_async(rgb, depth, K)


def test_from_estimators_requires_registered(scene):
    meshes, _rgb, _depth, rp = scene
    tc = _cfg_pair()[1]
    fresh = TPose(mesh=meshes[0], cfg=tc, refiner_params=_refiner(rp, tc), device="cpu")
    with pytest.raises(RuntimeError):
        MultiTracker.from_estimators([fresh])
    with pytest.raises(ValueError):
        MultiTracker.from_estimators([])
    other = TPose(mesh=meshes[1], cfg=dataclasses.replace(
        tc, refiner=dataclasses.replace(tc.refiner, crop_ratio=1.4)), device="cpu")
    for e in (fresh, other):
        e.pose_last = torch.eye(4)
    with pytest.raises(ValueError):
        MultiTracker.from_estimators([fresh, other])  # one shared refiner config


def test_default_device_is_the_card(scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        MultiTracker(meshes=scene[0][:1])


def test_roi_matches_full_frame(scene):
    _meshes_, rgb, depth, _rp = scene
    full = _trackers(scene)[1]
    roi = _trackers(scene, **ROI)[1]
    assert roi._roi_windows(K, H, W) is not None
    p_roi = roi.track(rgb, depth, K, iteration=2)
    np.testing.assert_allclose(p_roi, full.track(rgb, depth, K, iteration=2), atol=ROI_GAP, rtol=0)
    assert np.abs(p_roi - _poses()).max() > 1e-2  # against moves of this size


def _corrupt_hint(tracker):
    bad = tracker._pose_hints.copy()
    bad[1, 0, 3] -= 0.35  # ~120 px left at z = 0.8: the window misses the ball
    tracker._pose_hints = bad


def test_roi_violation_recovers_and_cascades(scene, caplog):
    """A window that misses its object: the fetch re-runs the frame
    full-frame; frames in flight re-run from the corrected chain; the next
    frame continues from it, windowed again. The re-run frames equal
    full-frame tracking, and the JAX MultiTracker's recovery."""
    _meshes_, rgb, depth, _rp = scene
    full = _trackers(scene)[1]
    want = [full.track(rgb, depth, K, iteration=2) for _ in range(3)]
    j, t = _trackers(scene, **ROI)
    for tr in (j, t):
        _corrupt_hint(tr)
    with caplog.at_level(logging.WARNING):
        futs = [t.track_async(rgb, depth, K, iteration=2) for _ in range(2)]
        got = [f.result() for f in futs]
    assert any("ROI violated" in r.message for r in caplog.records)
    assert t._chain_repair is None
    got.append(t.track(rgb, depth, K, iteration=2))
    np.testing.assert_array_equal(np.stack(got[:2]), np.stack(want[:2]))
    np.testing.assert_allclose(got[2], want[2], atol=ROI_GAP, rtol=0)
    assert t.track_stats == {"frames": 3, "roi_recoveries": 1, "chain_repairs": 1}
    np.testing.assert_allclose(got[0], j.track(rgb, depth, K, iteration=2), atol=1e-4, rtol=0)


def test_roi_deepim_deltas_per_object(scene):
    """"deepim" deltas read K: in ROI mode each object applies its own
    window's K (a per-object delta). The K of another window would move
    the object by the windows' offset (~0.2 m here)."""
    meshes, rgb, depth, _rp = scene
    rp, _sp = _weights(0.05, seed=7)
    rp["trans_head"]["1"]["bias"] = rp["trans_head"]["1"]["bias"] + np.float32([0, 0, 1])  # z scale ~1
    tc = _cfg_pair()[1]
    tc = dataclasses.replace(tc, refiner=dataclasses.replace(tc.refiner, trans_rep="deepim"))
    full = _port_tracker(meshes, tc, rp)
    roi = _port_tracker(meshes, dataclasses.replace(tc, **ROI), rp)
    assert roi._roi_windows(K, H, W) is not None
    p_roi = roi.track(rgb, depth, K, iteration=2)
    np.testing.assert_allclose(p_roi, full.track(rgb, depth, K, iteration=2), atol=ROI_GAP, rtol=0)
    assert np.abs(p_roi - _poses()).max() > 1e-3
