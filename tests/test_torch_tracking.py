"""The port's video-tracking path against foundationpose_tpu on the same
inputs and weights: the upload wire formats, track_one_async with its
window check, chain repair and batched fetch, and the device chain
(tests/test_torch_register_window.py holds the packed, windowed
register).

Test width (base_width 4, 32x32 crops, f32), the 240x320 scene of
tests/test_pipeline.py, depth scorer. Tolerances: pack bytes and
unpacked values exact; poses 1e-4 against JAX (2.4e-7 observed), 1e-5
between the port's own windowed and full-frame runs (a shifted
principal point rounds differently), 1e-3 between packed and unpacked
uploads (0.125 mm depth quantization through a live refiner, as the JAX
package's own test bounds it).
"""
import dataclasses
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.pipeline import FoundationPose as JPose
from foundationpose_tpu.pipeline import graph as jg
from foundationpose_tpu.pipeline.estimator import roi_contains_pose as j_contains
from foundationpose_torch.models import networks as tnet
from foundationpose_torch.models.convert import params_from_jax, params_to_jax
from foundationpose_torch.ops.rasterizer import render_mesh_brute
from foundationpose_torch.pipeline import FoundationPose as TPose
from foundationpose_torch.pipeline import fetch_track_results
from foundationpose_torch.pipeline import graph as tg
from foundationpose_torch.pipeline.estimator import roi_contains_pose
from test_torch_pipeline import _box, _cfgs

K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1.0]], np.float32)
H, W = 240, 320
T0 = (0.04, -0.03, 1.25)  # far enough that the windows are smaller than the frame
UPLOADS = ("register_pack", "register_roi", "track_pack", "track_roi")


def _frame(box, t=T0, hw=(H, W), Kc=K):
    """The box rendered by the port's plain rasterizer at translation t:
    numpy (rgb u8, depth f32, mask u8), the same inputs for both packages."""
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = t
    fr = render_mesh_brute(
        torch.as_tensor(box.vertices, dtype=torch.float32), torch.as_tensor(box.faces),
        torch.as_tensor(gt[None]), torch.as_tensor(Kc), out_hw=hw,
        vertex_color=torch.as_tensor(box.vertex_colors / 255.0, dtype=torch.float32),
        vnormals=torch.as_tensor(box.vertex_normals, dtype=torch.float32),
    )
    return ((fr.color[0].numpy() * 255).astype(np.uint8), fr.depth[0].numpy(),
            fr.mask[0].numpy().astype(np.uint8))


def _weights(head_scale, seed=0):
    """Seeded test-width RefineNet and ScoreNet as JAX param trees (numpy),
    drawn by the port (no JAX compile); delta heads scaled by head_scale."""
    rn = tnet.init_refine_net(tnet.RefineNetCfg(base_width=4), torch.Generator().manual_seed(seed))
    sn = tnet.init_score_net(tnet.ScoreNetCfg(base_width=4), torch.Generator().manual_seed(seed + 1))
    rp, sp = params_to_jax(rn.state_dict()), params_to_jax(sn.state_dict())
    for head in ("trans_head", "rot_head"):
        for k in ("kernel", "bias"):
            rp[head]["1"][k] = rp[head]["1"][k] * np.float32(head_scale)
    return rp, sp


def _pair(rp, sp, flags=None, **over):
    """JAX and port estimators on the box with the same weights (param
    trees of jnet) and upload flags (default: all on, as both packages'
    defaults)."""
    jc, tc = _cfgs("depth")
    kw = {**dict.fromkeys(UPLOADS, True), **(flags or {}), **over}
    jc = dataclasses.replace(jc, **kw)
    tc = dataclasses.replace(tc, **kw)
    tr = tnet.RefineNet(tc.refiner.net)
    tr.load_state_dict(params_from_jax(rp, tr.cfg))
    ts = tnet.ScoreNetMultiPair(tc.scorer.net)
    ts.load_state_dict(params_from_jax(sp, ts.cfg))
    box = _box()
    je = JPose(mesh=box, cfg=jc, refiner_params=jax.tree.map(jnp.asarray, rp),
               scorer_params=jax.tree.map(jnp.asarray, sp))
    te = TPose(mesh=box, cfg=tc, refiner_params=tr.eval(), scorer_params=ts.eval(), device="cpu")
    return je, te


def _port(rp, sp, flags=None, **over):
    return _pair(rp, sp, flags, **over)[1]


def _start(*ests, t=T0):
    """Put trackers of either package at the box's pose in `_frame(box, t)`
    (as a register would leave them, without its cost)."""
    gt = np.eye(4)
    gt[:3, 3] = t
    for e in ests:
        raw = gt @ np.linalg.inv(e.get_tf_to_centered_mesh())
        e.pose_last = (torch.as_tensor(raw, dtype=torch.float32) if isinstance(e, TPose)
                       else jnp.asarray(raw, jnp.float32))
        e._pose_hint = raw
        e._chain_repair = None


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in these modules: the suite runs several workers on
    a few cores, where torch's thread pools contend and small CPU ops run
    many times slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def live():
    """Live delta heads (scaled 0.05): a broken path moves the poses."""
    return _weights(0.05)


@pytest.fixture(scope="module")
def still():
    """Zeroed delta heads: identity refinement keeps the windows fixed."""
    return _weights(0.0)


@pytest.fixture(scope="module")
def box_frame():
    return _frame(_box())


# ----------------------------------------------------------- wire formats


PACK_CASES = [
    ((48, 64), 0, 0),
    ((37, 40), 321, 77),  # odd height, offsets past one byte
    ((40, 56), 1000, 513),
]


def _pack_inputs(hw, seed=11):
    rng = np.random.default_rng(seed)
    h, w = hw
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    depth = rng.uniform(0.0, 16.0, size=(h, w)).astype(np.float32)  # high byte >= 128
    depth[rng.uniform(size=(h, w)) < 0.2] = 0.0
    depth[rng.uniform(size=(h, w)) < 0.05] = np.nan  # sensor NaNs -> invalid
    depth[0, :3] = [70.0, -1.0, 16.38375]  # clipped high, clipped low, rounds to 65535
    mask = (rng.uniform(size=(h, w)) < 0.4).astype(np.uint8) * 7
    return rgb, depth, mask


@pytest.mark.parametrize("kind", ["track", "register"])
@pytest.mark.parametrize("hw, x0, y0", PACK_CASES)
def test_pack_bytes_equal_jax(kind, hw, x0, y0):
    rgb, depth, mask = _pack_inputs(hw)
    if kind == "register" and hw[0] * hw[1] % 8:
        with pytest.raises(ValueError):
            tg.pack_register_frame(rgb, depth, mask, x0, y0)
        return
    if kind == "track":
        want = jg.pack_track_frame(rgb, depth, x0, y0)
        got = tg.pack_track_frame(rgb, depth, x0, y0)
        staged = np.zeros(got.size + 13, np.uint8)
        in_place = tg.pack_track_frame(rgb, depth, x0, y0, out=staged)
    else:
        want = jg.pack_register_frame(rgb, depth, mask, x0, y0)
        got = tg.pack_register_frame(rgb, depth, mask, x0, y0)
        staged = np.zeros(got.size + 13, np.uint8)
        in_place = tg.pack_register_frame(rgb, depth, mask, x0, y0, out=staged)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert in_place.base is staged and in_place.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", ["track", "register"])
def test_unpack_exact_vs_jax(kind):
    """The port's device-side unpack (int32 byte joins) gives exactly the
    values of the JAX package's (uint16 joins), run eagerly: under jit
    XLA turns /255 into a multiply by the reciprocal (1 ulp)."""
    h, w = 40, 56
    rgb, depth, mask = _pack_inputs((h, w), seed=3)
    if kind == "track":
        buf = jg.pack_track_frame(rgb, depth, 777, 301)
        want = jg.unpack_track_frame(jnp.asarray(buf), (h, w))
        got = tg.unpack_track_frame(torch.from_numpy(buf), (h, w))
    else:
        buf = jg.pack_register_frame(rgb, depth, mask, 48, 321)
        want = jg.unpack_register_frame(jnp.asarray(buf), (h, w))
        got = tg.unpack_register_frame(torch.from_numpy(buf), (h, w))
        np.testing.assert_array_equal(got[2].numpy(), mask > 0)
    for g, j in zip(got, want):
        j = np.asarray(j)
        assert g.numpy().dtype == j.dtype
        np.testing.assert_array_equal(g.numpy(), j)
    d = got[1].numpy()
    fin = np.isfinite(depth) & (depth >= 0) & (depth < 16.38)
    assert np.abs(d[fin] - depth[fin]).max() <= 0.5 / tg.DEPTH_PACK_SCALE + 2e-6
    assert (d[~np.isfinite(depth)] == 0).all()


def test_shift_principal_point_matches_jax():
    Kb = np.stack([K, K * 1.5]).astype(np.float32)
    x0 = np.float32([321.0, 7.0])
    y0 = np.float32([77.0, 513.0])
    got = tg.shift_principal_point(torch.as_tensor(Kb), torch.as_tensor(x0), torch.as_tensor(y0))
    want = jnp.asarray(Kb).at[:, 0, 2].add(-x0).at[:, 1, 2].add(-y0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_config_defaults_match_jax():
    from foundationpose_tpu.pipeline import EstimatorCfg as JCfg
    from foundationpose_torch.pipeline import EstimatorCfg as TCfg

    for name in UPLOADS + ("track_roi_margin", "register_roi_margin"):
        assert getattr(TCfg(), name) == getattr(JCfg(), name), name


# --------------------------------------------------------------- tracking


def _moving(box, n, dx=0.003):
    return [_frame(box, (T0[0] + dx * i, T0[1], T0[2])) for i in range(n)]


@pytest.fixture(scope="module")
def video():
    return _moving(_box(), 4)


def test_track_packed_roi_matches_jax_and_unpacked(live, video):
    """Packed windowed tracking (the default) against the JAX package's,
    and against the port's unpacked full-frame tracking, live heads."""
    je, te = _pair(*live)
    plain = _port(*live, flags=dict.fromkeys(UPLOADS, False))
    _start(je, te, plain)
    before = te._pose_hint.copy()
    for r, d, _m in video[1:]:
        assert te._track_roi_window(K, H, W) == je._track_roi_window(K, H, W) is not None
        qj = je.track_one(r, d, K, iteration=2)
        qt = te.track_one(r, d, K, iteration=2, extra=None)
        qp = plain.track_one(r, d, K, iteration=2)
        np.testing.assert_allclose(qt, qj, atol=1e-4, rtol=0)
        np.testing.assert_allclose(qt, qp, atol=1e-3, rtol=0)
    assert np.abs(te._pose_hint - before).max() > 1e-4  # the heads moved the pose
    assert te.track_stats == {"frames": 3, "roi_recoveries": 0, "chain_repairs": 0}


def test_track_roi_matches_full_frame(still, box_frame):
    rgb, depth, _mask = box_frame
    poses = {}
    for name, roi in (("full", False), ("roi", True)):
        e = _port(*still, track_roi=roi)
        _start(e)
        for _ in range(3):
            poses[name] = e.track_one(rgb, depth, K, iteration=1)
        assert (e._track_roi_window(K, H, W) is not None) == roi
    np.testing.assert_allclose(poses["roi"], poses["full"], atol=1e-5, rtol=0)


def _forge_stale_hint(e):
    """Move the window away from the object: the crop of the (unmoved)
    refined pose then pokes out of it."""
    stale = e._pose_hint.copy()
    stale[:3, 3] = [-0.25, 0.2, 1.25]
    e._pose_hint = stale
    assert e._track_roi_window(K, H, W) is not None
    return stale


def test_track_roi_violation_recovers_like_jax(still, box_frame, caplog):
    rgb, depth, _mask = box_frame
    je, te = _pair(*still)
    out = {}
    for name, e in (("jax", je), ("port", te)):
        _start(e)
        p_ok = e.track_one(rgb, depth, K, iteration=2)
        stale = _forge_stale_hint(e)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            p = e.track_one(rgb, depth, K, iteration=2)
        assert any("ROI violated" in r.message for r in caplog.records)
        np.testing.assert_allclose(p, p_ok, atol=1e-5, rtol=0)  # re-ran from the same input
        assert np.linalg.norm(e._pose_hint[:3, 3] - stale[:3, 3]) > 0.1  # hint refreshed
        out[name] = p
    assert te.track_stats == {"frames": 2, "roi_recoveries": 1, "chain_repairs": 0}
    np.testing.assert_allclose(out["port"], out["jax"], atol=1e-4, rtol=0)


def test_track_roi_violation_cascades_through_pipeline(still, box_frame):
    """Two frames in flight when the first one's window fails: the second
    re-runs from the corrected chain when fetched, so the pipelined poses
    equal sequential full-frame tracking, and the chain continues from
    the corrected pose."""
    rgb, depth, _mask = box_frame
    full = _port(*still, track_roi=False)
    _start(full)
    want = [full.track_one(rgb, depth, K, iteration=1) for _ in range(3)]
    e = _port(*still)
    _start(e)
    _forge_stale_hint(e)
    futs = [e.track_one_async(rgb, depth, K, iteration=1) for _ in range(2)]
    got = [f.result() for f in futs]
    assert e._chain_repair is None
    got.append(e.track_one(rgb, depth, K, iteration=1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert e.track_stats == {"frames": 3, "roi_recoveries": 1, "chain_repairs": 1}


def test_out_of_order_fetch_warns(still, box_frame, caplog):
    rgb, depth, _mask = box_frame
    e = _port(*still)
    _start(e)
    _forge_stale_hint(e)
    a, b, c = (e.track_one_async(rgb, depth, K, iteration=1) for _ in range(3))
    a.result()  # its window failed: a correction waits for b
    with caplog.at_level(logging.WARNING):
        c.result()  # fetched before b: the correction cannot cascade
    assert any("could not cascade" in r.message for r in caplog.records)
    assert e._chain_repair is None


@pytest.mark.parametrize("heads, track_roi", [("live", False), ("still", True)])
def test_async_pipelined_and_batched_fetch_match_sequential(heads, track_roi, request, video,
                                                            monkeypatch):
    """Frames enqueued ahead of their fetch (track_one_async), fetched one
    by one or in batches (fetch_track_results: one transfer), give the
    poses of blocking track_one calls. Full-frame with live heads: the same
    operations, bit-equal. Windowed with zeroed heads (the JAX package's
    test): a live pose moves the lagging windows, whose shifted principal
    point rounds otherwise (1e-4 apart, not an error)."""
    params = request.getfixturevalue(heads)

    def fresh():
        e = _port(*params, track_roi=track_roi)
        _start(e)
        return e

    frames = video[1:] * 2
    e1 = fresh()
    seq = [e1.track_one(r, d, K, iteration=1) for r, d, _ in frames]
    e2 = fresh()
    futs = [e2.track_one_async(r, d, K, iteration=1) for r, d, _ in frames]
    futs[0].result()  # one already resolved in the first batch
    stacks = []
    orig = torch.stack
    monkeypatch.setattr(torch, "stack", lambda *a, **k: stacks.append(1) or orig(*a, **k))
    got = fetch_track_results(futs[:4]) + fetch_track_results(futs[4:])
    monkeypatch.undo()
    assert len(stacks) == 2  # one stacked fetch per batch
    if track_roi:
        for g, q in zip(got, seq):
            np.testing.assert_allclose(g, q, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(np.stack(got), np.stack(seq))
        assert np.abs(seq[-1] - seq[0]).max() > 1e-4  # the heads moved the pose
    np.testing.assert_array_equal(futs[-1].result(), got[-1])  # cached
    assert e2.track_stats["frames"] == len(seq)


def test_track_requires_register(still):
    e = _port(*still)
    with pytest.raises(RuntimeError):
        e.track_one_async(np.zeros((H, W, 3), np.uint8), np.zeros((H, W), np.float32), K)


# ------------------------------------------------------------------ chain


def test_chain_matches_per_frame_packed_and_jax(live, video):
    """track_chain_graph over k staged packed frames equals k
    track_graph_packed calls (bit-equal on the CPU: the same operations),
    and the JAX package's per-frame packed tracking (1e-4)."""
    je, te = _pair(*live)
    bufs = np.stack([tg.pack_track_frame(r, d, 0, 0) for r, d, _ in video])
    pose0 = np.eye(4, dtype=np.float32)
    pose0[:3, 3] = [0.035, -0.025, 1.24]
    p0 = torch.as_tensor(pose0)
    Kt = torch.as_tensor(K)
    args = (te.refiner, te.cfg, te.mesh_tensors)
    seq, p = [], p0
    for b in bufs:
        p = tg.track_graph_packed(*args, p, Kt, torch.from_numpy(b), te._diam, (H, W), 2)
        seq.append(p)
    chain = tg.track_chain_graph(*args, p0, Kt, bufs, te._diam, (H, W), 2)
    assert chain.shape == (len(video), 4, 4)
    np.testing.assert_array_equal(chain.numpy(), torch.stack(seq).numpy())
    assert np.abs(chain[-1].numpy() - chain[0].numpy()).max() > 1e-4  # it tracked
    pj, jseq = jnp.asarray(pose0), []
    for b in bufs:
        pj = jg.track_graph_packed(je.refiner_params, je.cfg, je.mesh_tensors, pj, jnp.asarray(K),
                                   jnp.asarray(b), jnp.float32(je.diameter), hw=(H, W),
                                   iterations=2)
        jseq.append(np.asarray(pj))
    np.testing.assert_allclose(chain.numpy(), np.stack(jseq), atol=1e-4, rtol=0)


def test_roi_contains_pose_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        p = np.eye(4)
        p[:3, 3] = rng.uniform([-0.4, -0.3, -0.1], [0.4, 0.3, 2.0])
        roi = (int(rng.integers(0, 200)), int(rng.integers(0, 100)), int(rng.choice([64, 128, 192])))
        args = (p, K, H, W, roi, 0.28, float(rng.uniform(1.0, 1.6)))
        assert roi_contains_pose(*args) == j_contains(*args)
