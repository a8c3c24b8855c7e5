"""The tracking path's captured steps (pipeline/step_graphs.py) on the CPU,
where a StepGraph runs its body eagerly through its static inputs and
output: each captured path bit-equal to its eager body, results copied
out of the static output (frames in flight), window recovery and chain
repair through cached steps, the cache's keys and its invalidation, and a
short video against the JAX estimator's track_one.

Test width (base_width 4, 32x32 crops, f32) on the scenes of
tests/test_torch_tracking.py and tests/test_torch_multi.py. Tolerances:
captured against eager and pipelined against sequential bit-equal (the
same operations); against the JAX package 1e-4, as
test_torch_tracking.py holds the same comparison.
"""
import numpy as np
import pytest
import torch

from chip_smoke import captured_against_eager
from foundationpose_torch.pipeline import MultiTracker, fetch_track_results
from test_torch_pipeline import _box
from test_torch_multi import POSES, _composite, _meshes, _poses, _refiner
from test_torch_tracking import (  # noqa: F401
    H, K, UPLOADS, W, _moving, _pair, _port, _start, _weights, one_torch_thread,
)

PATHS = [
    "track (unpacked, full frame)",
    "track_packed (full frame)",
    "track_packed (window 64)",
    "track_packed (window 128)",
    "multi (unpacked, full frame)",
    "multi_packed (full frame)",
    "multi_roi (unpacked, windows 128)",
    "multi_roi_packed (windows 128)",
]


@pytest.fixture(scope="module")
def live():
    return _weights(0.05)


@pytest.fixture(scope="module")
def still():
    return _weights(0.0)


@pytest.fixture(scope="module")
def video():
    return _moving(_box(), 4)


@pytest.fixture(scope="module")
def paths(live):
    """Every captured path and its eager body on two frames of the box and
    the ball (tests/test_torch_multi.py's scene, the second frame moved)."""
    rp, sp = live
    meshes = _meshes()
    est = _port(rp, sp)
    _start(est, t=POSES[0])
    multi = MultiTracker(meshes=meshes, cfg=est.cfg, refiner_params=_refiner(rp, est.cfg),
                         device="cpu")
    multi.set_poses(_poses())
    moved = _poses()
    moved[:, 0, 3] += 0.004
    frames = [_composite(meshes, _poses()), _composite(meshes, moved)]
    return captured_against_eager(est, multi, frames, K, (64, 128))


@pytest.mark.parametrize("path", PATHS)
def test_captured_path_bit_equal_to_eager_body(paths, path):
    got, want, graphs = paths[path]
    assert torch.equal(got, want)
    assert len(graphs) == 1  # the second frame replayed the first frame's step
    assert not torch.equal(got[0], got[1])  # it read the second frame and pose


def test_every_captured_path_is_checked(paths):
    assert sorted(paths) == sorted(PATHS)


def _fresh(params, **over):
    e = _port(*params, **over)
    _start(e)
    return e


def test_frames_in_flight_get_their_own_pose(live, video):
    """Eight frames enqueued (the upload ring's depth), then fetched in one
    batch: each pose is its own frame's, as sequential track_one gives it,
    not the last replay's static output."""
    frames = (video[1:] * 3)[:8]
    seq_e = _fresh(live, track_roi=False)
    seq = [seq_e.track_one(r, d, K, iteration=2) for r, d, _m in frames]
    e = _fresh(live, track_roi=False)
    futs = [e.track_one_async(r, d, K, iteration=2) for r, d, _m in frames]
    got = fetch_track_results(futs)
    np.testing.assert_array_equal(np.stack(got), np.stack(seq))
    assert np.abs(seq[-1] - seq[0]).max() > 1e-4  # the heads moved the pose
    assert len(e._graphs) == len(seq_e._graphs) == 1
    assert e.pose_last is not e._graphs.items()[0][1].output


def test_recovery_and_chain_repair_through_cached_steps(still, video):
    """A window the object left, two frames in flight: the fetch re-runs the
    frame full-frame, the frame in flight re-runs from the corrected chain,
    each from a cached step: the poses of full-frame sequential tracking."""
    rgb, depth, _m = video[0]
    full = _fresh(still, track_roi=False)
    want = [full.track_one(rgb, depth, K, iteration=1) for _ in range(3)]
    e = _fresh(still)
    stale = e._pose_hint.copy()
    stale[:3, 3] = [-0.25, 0.2, 1.25]
    e._pose_hint = stale
    futs = [e.track_one_async(rgb, depth, K, iteration=1) for _ in range(2)]
    got = fetch_track_results(futs)
    assert e._chain_repair is None
    got.append(e.track_one(rgb, depth, K, iteration=1))
    np.testing.assert_array_equal(np.stack(got[:2]), np.stack(want[:2]))
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    assert e.track_stats == {"frames": 3, "roi_recoveries": 1, "chain_repairs": 1}
    sizes = sorted(key[0][1] for key, _g in e._graphs.items())
    assert sizes == [(192, 192), (H, W)]  # the window's step and the full frame's


def test_a_new_window_size_adds_one_step_and_the_same_size_reuses_it(still, video):
    rgb, depth, _m = video[0]
    e = _fresh(still)
    hint = e._pose_hint.copy()
    assert e._track_roi_window(K, H, W)[2] == 192
    e.track_one(rgb, depth, K, iteration=1)
    (key192, step192), = e._graphs.items()
    far = hint.copy()
    far[:3, 3] *= 1.3  # the same projection, farther: a smaller window
    e._pose_hint = far
    assert e._track_roi_window(K, H, W)[2] == 128
    e.track_one(rgb, depth, K, iteration=1)
    assert len(e._graphs) == 2 and e.track_stats["roi_recoveries"] == 0
    assert e._track_roi_window(K, H, W)[2] == 192
    e.track_one(rgb, depth, K, iteration=1)
    assert len(e._graphs) == 2 and dict(e._graphs.items())[key192] is step192


def _tracked(e, frame, n=2):
    _start(e)
    return [e.track_one(frame[0], frame[1], K, iteration=2) for _ in range(n)]


def test_weights_loaded_in_place_and_load_weights(live, video, tmp_path):
    """load_state_dict into the refiner keeps its tensors (a captured step
    reads the new weights); load_weights replaces the refiner and drops
    the cached steps. Either way the poses are a fresh estimator's."""
    other = _weights(0.05, seed=3)
    want = _tracked(_port(*other), video[1])
    e = _port(*live)
    _tracked(e, video[1], 1)
    assert len(e._graphs) == 1
    e.refiner.load_state_dict(_port(*other).refiner.state_dict())
    assert len(e._graphs) == 1
    np.testing.assert_array_equal(np.stack(_tracked(e, video[1])), np.stack(want))
    e2 = _port(*live)
    _tracked(e2, video[1], 1)
    path = str(tmp_path / "refiner.npz")
    _port(*other).save_weights(refiner_path=path)
    e2.load_weights(refiner_path=path)
    assert len(e2._graphs) == 0
    np.testing.assert_array_equal(np.stack(_tracked(e2, video[1])), np.stack(want))


@pytest.mark.parametrize("name", ["refiner", "cfg", "mesh_tensors"])
def test_assigning_what_a_step_reads_drops_the_cached_steps(live, video, name):
    e = _port(*live)
    _tracked(e, video[1], 1)
    assert len(e._graphs) == 1
    setattr(e, name, getattr(e, name))
    assert len(e._graphs) == 0


def test_two_reset_objects_drop_the_cached_steps(live):
    """Box, ball, box again: each reset_object drops the cached steps (the
    render mesh is read by address), and each object tracks as a fresh
    estimator does."""
    rp, sp = live
    box, ball = _meshes()
    frame = _composite([box, ball], _poses())

    def tracked(e, t):
        _start(e, t=t)
        return [e.track_one(frame[0], frame[1], K, iteration=2) for _ in range(2)]

    e = _port(rp, sp)
    for mesh, t in ((box, POSES[0]), (ball, POSES[1]), (box, POSES[0])):
        e.reset_object(mesh=mesh)
        assert len(e._graphs) == 0
        got = tracked(e, t)
        assert len(e._graphs) == 1
        fresh = _port(rp, sp)
        fresh.reset_object(mesh=mesh)
        np.testing.assert_array_equal(np.stack(got), np.stack(tracked(fresh, t)))


def test_multi_add_object_drops_the_cached_steps(live):
    rp, _sp = live
    box, ball = _meshes()
    cfg = _port(*live).cfg
    extra = box.copy()
    poses3 = np.concatenate([_poses(), _poses()[:1]])
    poses3[2, :3, 3] = [0.02, 0.06, 1.0]
    frame = _composite([box, ball, extra], poses3)
    t = MultiTracker(meshes=[box, ball], cfg=cfg, refiner_params=_refiner(rp, cfg), device="cpu")
    t.set_poses(_poses())
    t.track(frame[0], frame[1], K, iteration=2)
    assert len(t._graphs) == 1
    t.add_object(extra)
    assert len(t._graphs) == 0
    t.set_poses(poses3)
    got = [t.track(frame[0], frame[1], K, iteration=2) for _ in range(2)]
    fresh = MultiTracker(meshes=[box, ball, extra], cfg=cfg, refiner_params=_refiner(rp, cfg),
                         device="cpu")
    fresh.set_poses(poses3)
    np.testing.assert_array_equal(np.stack(got), np.stack(
        [fresh.track(frame[0], frame[1], K, iteration=2) for _ in range(2)]))
    assert len(t._graphs) == 1


@pytest.mark.parametrize("uploads", ["packed, windows", "unpacked, full frame"])
def test_short_video_matches_jax_track_one(live, video, uploads):
    flags = None if uploads == "packed, windows" else dict.fromkeys(UPLOADS, False)
    je, te = _pair(*live, flags=flags)
    _start(je, te)
    for r, d, _m in video[1:]:
        np.testing.assert_allclose(te.track_one(r, d, K, iteration=2),
                                   je.track_one(r, d, K, iteration=2), atol=1e-4, rtol=0)
    assert len(te._graphs) >= 1
