"""The port's span-and-counter recorder (foundationpose_torch/utils/
profiling.py) on the CPU: the request a register, a tracked frame and a
train step leave (host spans, their parents, one request id, the step's
device stages in order), nothing while recording is off, the host spans in
a `profiling.trace` Chrome trace, full-frame re-runs nested in their
request beside the estimator's own counters, a replay's read dropped when
its graph is replayed again first, the capture counters across `clear()`,
the bounded ring, and the benchmark's readers of it.

Test width (base_width 4, 32x32 crops, f32, depth scorer, 84 hypotheses)
on a 240x320 frame of the box far enough away that the register and the
tracked frames upload windows. On the CPU a step runs its body eagerly and
its device stages are timed on the host clock; tests/test_torch_gpu.py
holds a replay's stages on the card.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from chip_smoke import _box, _estimator, _frame, _small_cfg
from foundationpose_torch.models import networks as tnet
from foundationpose_torch.models import training
from foundationpose_torch.pipeline import step_graphs
from foundationpose_torch.utils import profiling

K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1.0]], np.float32)
T0 = (0.04, -0.03, 1.25)  # the box's crop is smaller than the frame: windowed uploads
REGISTER_HOST = ["register.window", "register.upload", "register.step", "register.window_check",
                 "register.fetch"]
TRACK_HOST = ["track.window", "track.upload", "track.step", "track.fetch", "track.check"]


@pytest.fixture(autouse=True)
def recorder():
    """A recorder with nothing kept, recording; off again after the test."""
    profiling.reset()
    profiling.enable()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def scene():
    box = _box()
    cfg = dataclasses.replace(_small_cfg(), register_pack=True, register_roi=True, track_pack=True,
                              track_roi=True, inplane_step_deg=180)
    frame = tuple(np.asarray(x) for x in _frame(box, T0, (240, 320), K, "cpu"))
    return box, cfg, frame


def _est(scene, **over):
    box, cfg, _frame = scene
    return _estimator(box, dataclasses.replace(cfg, **over), "cpu", head_scale=0.05)


def _tree(req):
    """[(name, clock, parent's name)] in the order the spans were opened."""
    return [(s.name, s.clock, None if s.parent is None else req.spans[s.parent].name)
            for s in req.spans]


def _stages(req, root):
    """The names of the device stages under the device span `root`."""
    i = req.spans.index(root)
    return [s.name for s in req.spans if s.parent == i]


@pytest.mark.parametrize("funnel", [None, (1, 8)], ids=["full", "funneled"])
def test_register_leaves_one_request(scene, funnel):
    over = {} if funnel is None else dict(prune_after_iter=funnel[0], prune_keep=funnel[1])
    est = _est(scene, **over)
    est.register(K, *scene[2], iteration=2)
    (req,) = profiling.requests("register")
    tree = _tree(req)
    assert [n for n, c, p in tree if c == "host" and p is None] == REGISTER_HOST
    assert ("register.pack", "host", "register.upload") in tree
    assert tree.count(("register.wait", "host", "register.fetch")) == 3
    assert ("register.wait", "host", "register.window_check") in tree
    assert all(s.request == req.id for s in req.spans)
    (root,) = req.named("step")
    assert root.clock == "device" and req.spans[root.parent].name == "register.step"
    per_iter = ["crops", "refiner", "update"]
    score = ["score.crops", "score.net", "rank"]
    want = ["prep"] + (per_iter * 2 + score if funnel is None else per_iter + score + per_iter + score)
    assert _stages(req, root) == want
    stages = [s for s in req.spans if s.clock == "device" and s is not root]
    assert all(s.duration >= 0 for s in stages)
    assert root.covered == pytest.approx(sum(s.duration for s in stages))
    assert 0 <= root.self_time < root.duration
    waits = req.seconds("register.wait")
    assert 0 < waits < req.host_seconds()
    assert est.register_roi_recoveries == 0 and not req.named("register.rerun")


def test_tracked_frame_leaves_one_request(scene):
    est = _est(scene)
    est.register(K, *scene[2], iteration=1)
    for _ in range(2):
        est.track_one(scene[2][0], scene[2][1], K, iteration=2)
    assert len(profiling.requests("register")) == 1
    reqs = profiling.requests("track")
    assert len(reqs) == 2 and reqs[0].id != reqs[1].id
    for req in reqs:
        tree = _tree(req)
        assert [n for n, c, p in tree if c == "host" and p is None] == TRACK_HOST
        assert ("track.pack", "host", "track.upload") in tree
        assert ("track.wait", "host", "track.fetch") in tree
        (root,) = req.named("step")
        assert req.spans[root.parent].name == "track.step"
        assert _stages(req, root) == ["prep"] + ["crops", "refiner", "update"] * 2
        assert all(s.request == req.id for s in req.spans)
    assert profiling.requests("track", last=1) == reqs[1:]
    assert est.track_stats == {"frames": 2, "roi_recoveries": 0, "chain_repairs": 0}


def test_nothing_recorded_while_off(scene):
    profiling.disable()
    assert not profiling.recording() and profiling.begin("register") is None
    est = _est(scene)
    est.register(K, *scene[2], iteration=1)
    est.track_one(scene[2][0], scene[2][1], K, iteration=1)
    assert profiling.requests("register") == [] and profiling.requests("track") == []
    assert profiling.counters() == {}
    assert profiling.span("track.pack") is profiling.span("register.step")  # one shared no-op


def test_host_spans_appear_in_the_chrome_trace(scene, tmp_path):
    est = _est(scene)
    est.register(K, *scene[2], iteration=1)
    profiling.disable()  # the profiler alone turns recording on
    profiling.reset()
    with profiling.trace(str(tmp_path), name="frame"):
        est.track_one(scene[2][0], scene[2][1], K, iteration=1)
    names = {e.get("name") for e in json.load(open(tmp_path / "frame.json"))["traceEvents"]}
    assert set(TRACK_HOST + ["track.pack", "track.wait"]) <= names
    assert len(profiling.requests("track")) == 1 and not profiling.recording()


def test_window_reruns_nest_in_their_request(scene, caplog):
    """A refiner that pushes every pose out of the register's window: the
    register re-runs full-frame under `register.rerun`; a tracking window
    placed from a stale hint: the frame re-runs under `track.rerun`. The
    estimator's counters count both as before."""
    est = _est(scene)
    with torch.no_grad():
        est.refiner.trans_head[1].bias.copy_(torch.tensor([5.0, 0.0, 0.0]))
    est.register(K, *scene[2], iteration=1)
    assert est.register_roi_recoveries == 1
    (req,) = profiling.requests("register")
    tree = _tree(req)
    assert [n for n, c, p in tree if c == "host" and p is None] == REGISTER_HOST[:4] + [
        "register.rerun", "register.fetch"]
    assert ("register.upload", "host", "register.rerun") in tree
    assert ("register.step", "host", "register.rerun") in tree
    steps = req.named("step")
    assert len(steps) == 2  # the window's run and the full frame's
    assert [req.spans[req.spans[s.parent].parent].name if req.spans[s.parent].parent is not None
            else None for s in steps] == [None, "register.rerun"]

    est = _est(scene)
    est.register(K, *scene[2], iteration=1)
    est.track_one(scene[2][0], scene[2][1], K, iteration=1)
    stale = est._pose_hint.copy()
    stale[:3, 3] = [-0.25, 0.2, 1.25]
    est._pose_hint = stale
    est.track_one(scene[2][0], scene[2][1], K, iteration=1)
    assert est.track_stats["roi_recoveries"] == 1
    first, second = profiling.requests("track")
    assert not first.named("track.rerun")
    tree = _tree(second)
    assert ("track.rerun", "host", "track.check") in tree
    assert ("track.wait", "host", "track.rerun") in tree
    assert ("track.step", "host", "track.rerun") in tree
    assert len(second.named("step")) == 2


def test_replayed_again_before_its_read_drops_the_read():
    """Frames in flight: a graph replayed again before the earlier replay's
    stages were read drops that read (the events would hold the later
    replay's times) and counts it."""
    marks = [(None, 0.0), ("prep", 1.0), ("crops", 3.0), ("", 4.0)]
    first, second = profiling.begin("track"), profiling.begin("track")
    with profiling.within(first), profiling.span("track.step"):
        unread = profiling.replaying(marks, None)
    with profiling.within(second), profiling.span("track.step"):
        unread = profiling.replaying(marks, unread)
    profiling.finish(first)
    profiling.finish(second)
    assert profiling.counters() == {"device_reads_dropped": 1}
    a, b = profiling.requests("track")
    assert not a.has_device_spans()
    assert [(s.name, s.duration) for s in b.spans if s.clock == "device"] == [
        ("step", 4.0), ("prep", 2.0), ("crops", 1.0)]
    assert profiling.replaying(marks, None) is None  # outside a request: nothing to read


def test_train_step_leaves_one_request():
    torch.manual_seed(0)
    net = tnet.RefineNet(tnet.RefineNetCfg(base_width=4))
    cfg = training.TrainCfg(compute_dtype="float32")
    opt = training.make_optimizer(cfg, net, "cpu")
    batch = {"A": torch.rand(2, 32, 32, 6), "B": torch.rand(2, 32, 32, 6),
             "trans_target": torch.zeros(2, 3), "rot_target": torch.zeros(2, 3)}
    for _ in range(2):
        training.refine_train_step(net, opt, cfg, batch)
    reqs = profiling.requests("train")
    assert len(reqs) == 2
    for req in reqs:
        (root,) = req.named("step")
        assert root.parent is None and root.clock == "device"
        assert _stages(req, root) == ["train.forward", "train.backward", "train.adam"]
        assert all(s.duration > 0 for s in req.spans)


def test_capture_counters_survive_clear(monkeypatch):
    """StepGraphs counts each call that captured its step and the capture's
    seconds, and clear() keeps both (a capture is simulated: the CPU never
    captures)."""
    def call(self, *inputs):
        if self.graph is None:
            self.graph, self.capture_ms = object(), 250.0
        return inputs[0] + 1

    monkeypatch.setattr(step_graphs.StepGraph, "__call__", call)
    graphs = step_graphs.StepGraphs()
    x = torch.zeros(2)
    for _ in range(3):
        graphs.run("a", (), None, x)
    graphs.run("b", (), None, x)
    assert (graphs.captures, graphs.capture_s) == (2, 0.5)
    graphs.clear()
    assert len(graphs) == 0 and (graphs.captures, graphs.capture_s) == (2, 0.5)
    graphs.run("a", (), None, x)
    assert (graphs.captures, graphs.capture_s) == (3, 0.75)


def test_ring_stays_bounded():
    n = profiling.RING_REQUESTS + 10
    for _ in range(n):
        req = profiling.begin("frame")
        with profiling.within(req), profiling.span("frame.step"):
            pass
        profiling.finish(req)
    reqs = profiling.requests("frame")
    assert len(reqs) == profiling.RING_REQUESTS
    assert reqs[-1].id - reqs[0].id == profiling.RING_REQUESTS - 1
    assert len(profiling.requests("frame", last=5)) == 5
    profiling.reset()
    assert profiling.requests("frame") == []


def test_stage_timer_records_while_off():
    profiling.disable()
    with profiling.stage_timer("unit", sync=False):
        pass
    assert profiling.timing_report()["unit"]["count"] == 1
    (req,) = profiling.requests("stage")
    assert _tree(req) == [("unit", "host", None)]


def test_benchmark_readers_of_the_recorder(scene):
    """The benchmark's program_span metrics read the traced stretch's
    requests (the last `served`) and the estimator's capture counter."""
    from benchmark import harness

    est = _est(scene)
    est.register(K, *scene[2], iteration=1)
    est.track_one(scene[2][0], scene[2][1], K, iteration=1)
    est._graphs.capture_s = 0.25
    win = harness.Window(1.0, 1, [1.0])
    ctx = lambda kind: harness.Context({}, kind, types.SimpleNamespace(est=est), 1.0, win, win)  # noqa: E731
    read = lambda name, kind: harness.load_metric(name).read(ctx(kind))  # noqa: E731
    (reg,), (frame,) = profiling.requests("register"), profiling.requests("track")
    assert read("register.prep_ms", "register") == pytest.approx(reg.seconds("prep") * 1e3)
    assert read("register.crops_ms", "register") == pytest.approx(reg.seconds("crops", "score.crops") * 1e3)
    assert read("register.refiner_ms", "register") == pytest.approx(reg.seconds("refiner", "update") * 1e3)
    assert read("register.scorer_ms", "register") == pytest.approx(reg.seconds("score.net", "rank") * 1e3)
    host = (reg.host_seconds() - reg.seconds("register.wait")) * 1e3
    assert read("register.host_ms", "register") == pytest.approx(host)
    assert read("track.crops_ms", "track") == pytest.approx(frame.seconds("crops") * 1e3)
    assert read("track.pack_ms", "track") == pytest.approx(frame.seconds("track.upload") * 1e3)
    assert read("track.rerun_share", "track") == 0.0
    assert read("register.capture_s", "register") == read("track.capture_s", "track") == 0.25
    assert read("register.prep_ms", "track") is None and read("train.adam_ms", "train") is None
    profiling.reset()
    assert read("track.host_ms", "track") is None  # nothing recorded: nothing to read
