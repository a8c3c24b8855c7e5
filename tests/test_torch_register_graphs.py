"""The register's captured steps (pipeline/graph.py `register_graph`,
`register_graph_packed`; pipeline/step_graphs.py) on the CPU, where a
StepGraph runs its body eagerly through its static tensors: each path
against the JAX functions of the same names, each bit-equal to its eager
body, the first call of a key run eagerly and the second through the
step, the cache's invalidation and the window recovery through cached
steps. Every path is run with every config: the depth scorer, the
network scorer, and both funneled.

Test width (base_width 4, 32x32 crops, f32) on the box scene of
tests/test_torch_pipeline.py (`_registered`), 2 refine iterations; the
window recovery on the scene of tests/test_torch_register_window.py.
Tolerances: against the JAX package the top-5 order equal, poses and
scores within 1e-4 (as test_register_then_track_matches_jax); the
captured step against its eager body bit-equal (the same operations).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.pipeline import FoundationPose as JPose
from foundationpose_tpu.pipeline import graph as jg
from foundationpose_torch.pipeline import FoundationPose as TPose
from foundationpose_torch.pipeline import graph as tg
from foundationpose_torch.pipeline.step_graphs import StepGraphs
from test_torch_estimator_io import _spread_scorer
from test_torch_pipeline import KF, _box, _cfgs, _frame, _params
from test_torch_register_window import _shifting_params
from test_torch_tracking import K, _port, box_frame, one_torch_thread, still  # noqa: F401

ITERS = 2
FUNNEL = dict(prune_after_iter=1, prune_keep=8)
CFGS = {"depth": ("depth", {}), "network": ("network", {}), "funneled": ("depth", FUNNEL),
        "funneled network": ("network", FUNNEL)}
PATHS = ["unpacked", "packed full frame", "packed window"]
WINDOW = (32, 8, 96)  # x0, y0, size of the packed window on the 120x160 frame


@pytest.fixture(scope="module")
def frame():
    return _frame(_box())


def _estimators(name, frame):
    """(JAX estimator, port estimator) on the box with the same weights and
    config; the network scorer spread on the top 16 hypotheses of a first
    register (a funneled one's 8 survivors), so that its ranking is not
    rounding noise."""
    mode, extra = CFGS[name]
    box = _box()
    rp, sp, tr, ts = _params(head_scale=0.05)
    jc, tc = (dataclasses.replace(c, **extra) for c in _cfgs(mode))
    if mode == "network":
        probe = TPose(mesh=box, cfg=tc, refiner_params=tr, scorer_params=ts, device="cpu")
        probe.register(KF, *frame, iteration=ITERS)
        sp, ts = _spread_scorer(sp, probe.poses[:FUNNEL["prune_keep"] if extra else 16].numpy())
    je = JPose(mesh=box, cfg=jc, refiner_params=jax.tree.map(jnp.asarray, rp),
               scorer_params=jax.tree.map(jnp.asarray, sp))
    te = TPose(mesh=box, cfg=tc, refiner_params=tr, scorer_params=ts, device="cpu")
    return je, te


@pytest.fixture(scope="module")
def pairs(frame):
    return {name: _estimators(name, frame) for name in CFGS}


def _packed(path, frame):
    """(pack_register_frame buffer, (h, w)) of a packed path's upload."""
    rgb, depth, mask = frame
    if path == "packed window":
        x0, y0, s = WINDOW
        win = (slice(y0, y0 + s), slice(x0, x0 + s))
        return tg.pack_register_frame(rgb[win], depth[win], mask[win], x0, y0), (s, s)
    return tg.pack_register_frame(rgb, depth, mask), depth.shape


def _port_step(te, path, frame, graphs):
    args = (te.refiner, te.scorer, te.cfg, te.mesh_tensors, te.rot_grid, te.hyp_valid,
            torch.tensor(KF))
    if path == "unpacked":
        return tg.register_graph(*args, *map(torch.tensor, frame), te._diam, ITERS, graphs=graphs)
    buf, hw = _packed(path, frame)
    return tg.register_graph_packed(*args, torch.from_numpy(buf), te._diam, hw, ITERS,
                                    graphs=graphs)


def _eager_body(te, path, frame):
    """The eager bodies called directly."""
    args = (te.refiner, te.scorer, te.mesh_tensors, te._diam, te.cfg, te.rot_grid, te.hyp_valid,
            torch.tensor(KF))
    with torch.inference_mode():
        if path == "unpacked":
            rgb, depth, mask = map(torch.tensor, frame)
            return tg.register_body(*args, rgb.to(torch.float32) / 255.0, depth, mask, ITERS)
        buf, hw = _packed(path, frame)
        return tg.register_packed_body(*args, torch.from_numpy(buf), hw, ITERS)


def _jax_graph(je, te, path, frame):
    args = (je.refiner_params, je.scorer_params, je.cfg, je.mesh_tensors,
            jnp.asarray(te.rot_grid.numpy()), jnp.asarray(te.hyp_valid.numpy()), jnp.asarray(KF))
    diam = jnp.float32(te.diameter)
    if path == "unpacked":
        out = jg.register_graph(*args, *map(jnp.asarray, frame), diam, iterations=ITERS)
    else:
        buf, hw = _packed(path, frame)
        out = jg.register_graph_packed(*args, jnp.asarray(buf), diam, hw=tuple(hw), iterations=ITERS)
    return [np.asarray(o) for o in out]


def _by_hypothesis(order, rows):
    """rows (sorted by `order`) back in hypothesis order."""
    out = np.empty_like(rows)
    out[order] = rows
    return out


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("path", PATHS)
def test_register_graph_matches_jax(pairs, frame, path, name):
    """Each path and each config against the JAX graph of the same name
    (the step's two calls are bit-equal: the test below)."""
    je, te = pairs[name]
    want = _jax_graph(je, te, path, frame)
    got = [o.numpy() for o in _port_step(te, path, frame, StepGraphs())]
    np.testing.assert_array_equal(got[0][:5], want[0][:5])
    np.testing.assert_allclose(_by_hypothesis(got[0], got[1]), _by_hypothesis(want[0], want[1]),
                               atol=1e-4, rtol=0)
    sg, sw = _by_hypothesis(got[0], got[2]), _by_hypothesis(want[0], want[2])
    np.testing.assert_array_equal(np.isfinite(sg), np.isfinite(sw))
    fin = np.isfinite(sw)  # the padded hypotheses score -inf
    np.testing.assert_allclose(sg[fin], sw[fin], atol=1e-4, rtol=1e-4)  # rtol: the funnel's +1e5
    np.testing.assert_allclose(got[3], want[3], atol=1e-4, rtol=0)
    assert int(got[4]) == int(want[4])
    mode, extra = CFGS[name]
    if extra:
        assert int((got[2] > 1e4).sum()) == FUNNEL["prune_keep"]
    if mode == "network":  # the top of the ranking is not a near-tie
        assert got[2][0] - got[2][1] > 1e-3


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("path", PATHS)
def test_register_step_bit_equal_to_eager_body(pairs, frame, path, name):
    """The first call of a key runs the body through the static inputs and
    keeps no static output (on the card: captures nothing); the second
    goes through the step (on the card: captures and replays). Both give
    the eager body's result bit for bit, as fresh tensors."""
    _je, te = pairs[name]
    want = _eager_body(te, path, frame)
    graphs = StepGraphs()
    first = _port_step(te, path, frame, graphs)
    (key, step), = graphs.items()
    assert key[0][0] == ("register" if path == "unpacked" else "register_packed")
    assert key[0][-2] == ITERS
    assert key[0][-1] == ((FUNNEL["prune_after_iter"], FUNNEL["prune_keep"]) if CFGS[name][1]
                          else None)
    assert (step.eager_runs, step.replays, step.output, step.graph) == (1, 0, None, None)
    second = _port_step(te, path, frame, graphs)
    assert len(graphs) == 1 and step.replays == 1 and step.eager_runs == 1
    for got in (first, second):
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert all(g is not s for g, s in zip(second, step.output))


def _registered_twice(e, frame):
    return [e.register(KF, *frame, iteration=ITERS) for _ in range(2)]


def test_estimator_register_dispatches_the_step(pairs, frame):
    """FoundationPose.register goes through its cache: one key a frame
    size, eager at the first register and through the step at the
    second, with the eager body's result."""
    _je, te = pairs["depth"]
    e = TPose(mesh=_box(), cfg=te.cfg, refiner_params=te.refiner, scorer_params=te.scorer,
              device="cpu")
    p1, p2 = _registered_twice(e, frame)
    (key, step), = e._graphs.items()
    assert key[0] == ("register", ITERS, None)
    assert (step.eager_runs, step.replays) == (1, 1)
    np.testing.assert_array_equal(p1, p2)
    want = _eager_body(e, "unpacked", frame)
    assert torch.equal(e.order, want[0]) and torch.equal(e.poses, want[1])


def test_weights_loaded_in_place_reach_the_step(pairs, frame):
    """load_state_dict into the refiner and the scorer keeps their tensors:
    the cached step reads the new weights and gives the register of a
    fresh estimator with them."""
    _je, te = pairs["network"]
    _rp, _sp, tr0, ts0 = _params(head_scale=0.05)
    _rp, _sp, tr, ts = _params(head_scale=0.05, seed=5)
    e = TPose(mesh=_box(), cfg=te.cfg, refiner_params=tr0, scorer_params=ts0, device="cpu")
    _registered_twice(e, frame)
    (_key, step), = e._graphs.items()
    e.refiner.load_state_dict(tr.state_dict())
    e.scorer.load_state_dict(ts.state_dict())
    got = e.register(KF, *frame, iteration=ITERS)
    assert len(e._graphs) == 1 and step.replays == 2
    fresh = TPose(mesh=_box(), cfg=te.cfg, refiner_params=tr, scorer_params=ts, device="cpu")
    np.testing.assert_array_equal(got, fresh.register(KF, *frame, iteration=ITERS))


@pytest.mark.parametrize("change", ["load_weights", "reset_object", "scorer", "another object"])
def test_replacing_what_the_register_reads_drops_the_cache(pairs, frame, change, tmp_path):
    """Each change clears the cache, and the next register makes a new key.
    After a new object of another size and its rotation grid, both the
    eager and the captured register equal a fresh estimator's on it."""
    _je, te = pairs["depth"]
    e = TPose(mesh=_box(), cfg=te.cfg, refiner_params=te.refiner, scorer_params=te.scorer,
              device="cpu")
    before = e.register(KF, *frame, iteration=ITERS)
    assert len(e._graphs) == 1
    if change == "load_weights":
        path = str(tmp_path / "scorer.npz")
        e.save_weights(scorer_path=path)
        e.load_weights(scorer_path=path)
    elif change == "reset_object":
        e.reset_object(mesh=_box())
    elif change == "another object":
        obj = _box()
        obj.vertices = obj.vertices * (np.array((0.1, 0.14, 0.18)) / np.ptp(obj.vertices, axis=0))
        e.reset_object(mesh=obj)
        e.make_rotation_grid(min_n_views=e.cfg.min_n_views, inplane_step=e.cfg.inplane_step_deg)
    else:
        setattr(e, change, getattr(e, change))
    assert len(e._graphs) == 0
    got = e.register(KF, *frame, iteration=ITERS)
    (_key, step), = e._graphs.items()
    assert (step.eager_runs, step.replays) == (1, 0)  # a new key: eager again
    if change == "another object":
        fresh = TPose(mesh=obj, cfg=te.cfg, refiner_params=te.refiner, scorer_params=te.scorer,
                      device="cpu")
        want = fresh.register(KF, *frame, iteration=ITERS)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(e.register(KF, *frame, iteration=ITERS), want)
        assert step.replays == 1
        assert np.abs(want - before).max() > 1e-6  # the register read the new object


def test_window_recovery_through_cached_steps(still, box_frame):  # noqa: F811
    """A refiner that pushes every hypothesis out of the register window:
    each register re-runs full-frame, through the window's and the full
    frame's steps once both are cached, and returns the full-frame
    register's pose."""
    rp, sp = _shifting_params(still)
    te = _port(rp, sp)
    full = _port(rp, sp, register_roi=False)
    want = full.register(K, *box_frame, iteration=1)
    roi = te._register_roi_window(K, box_frame[1], box_frame[2])
    assert roi is not None
    for n in (1, 2):
        np.testing.assert_array_equal(te.register(K, *box_frame, iteration=1), want)
        assert te.register_roi_recoveries == n
    steps = dict(te._graphs.items())
    assert sorted(key[0][1] for key in steps) == sorted([(240, 320), (roi[2], roi[2])])
    assert all((s.eager_runs, s.replays) == (1, 1) for s in steps.values())


def test_window_result_survives_the_full_frame_replay(pairs, frame):
    """The recovery reads the window's result, then replays the full
    frame's step in the same pool: the window's result is a copy, still
    the window's eager body's."""
    _je, te = pairs["depth"]
    graphs = StepGraphs()
    for _ in range(2):  # the second round goes through both steps
        window = _port_step(te, "packed window", frame, graphs)
        full = _port_step(te, "packed full frame", frame, graphs)
    assert all(torch.equal(a, b) for a, b in zip(window, _eager_body(te, "packed window", frame)))
    assert not torch.equal(window[1], full[1])
