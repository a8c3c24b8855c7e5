"""The port's packed, windowed register against foundationpose_tpu on the
same inputs and weights: the detection-sized upload window, its
full-frame recovery, and the two fixed ADVICE findings (every valid
hypothesis's crop is checked against the window, and the window covers
the scorer's crop as well as the refiner's).

The scene, weights and tolerances are those of tests/test_torch_tracking.py.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np

from foundationpose_tpu.pipeline import FoundationPose as JPose
from foundationpose_tpu.pipeline import graph as jg
from foundationpose_tpu.pipeline.estimator import roi_contains_pose as j_contains
from test_torch_pipeline import _cfgs
from test_torch_tracking import (  # noqa: F401  (fixtures)
    H, K, UPLOADS, W, _pair, _port, box_frame, live, one_torch_thread, still)


def test_register_packed_roi_matches_jax(live, box_frame):
    """The default register (packed upload of a detection-sized window)
    against the JAX package's, and against the port's unpacked register."""
    je, te = _pair(*live)
    roi = te._register_roi_window(K, box_frame[1], box_frame[2])
    assert roi is not None and roi[2] < H and roi == je._register_roi_window(K, *box_frame[1:])
    pj = je.register(K, *box_frame, iteration=1)
    pt = te.register(K, *box_frame, iteration=1)
    assert te.register_roi_recoveries == je.register_roi_recoveries == 0
    assert te.best_id == je.best_id
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(te._pose_hint, je._pose_hint, atol=1e-4, rtol=0)
    plain = _port(*live, flags=dict.fromkeys(UPLOADS, False))
    pp = plain.register(K, *box_frame, iteration=1)
    assert plain.best_id == te.best_id
    np.testing.assert_allclose(pt, pp, atol=1e-3, rtol=0)


def _shifting_params(still):
    """A refiner whose translation head pushes every pose +5 diameter
    halves in x per iteration (the JAX package's recovery test)."""
    rp, sp = jax.tree.map(np.asarray, still[0]), still[1]
    rp["trans_head"]["1"]["bias"] = np.float32([5.0, 0.0, 0.0])
    return rp, sp


def test_register_roi_recovery_matches_jax(still, box_frame):
    rp, sp = _shifting_params(still)
    je, te = _pair(rp, sp)
    assert te._register_roi_window(K, box_frame[1], box_frame[2]) is not None
    pj = je.register(K, *box_frame, iteration=1)
    pt = te.register(K, *box_frame, iteration=1)
    assert te.register_roi_recoveries == je.register_roi_recoveries == 1
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    full = _port(rp, sp, register_roi=False)
    np.testing.assert_allclose(pt, full.register(K, *box_frame, iteration=1), atol=1e-6, rtol=0)
    assert full.register_roi_recoveries == 0


def _spreading_params(still, box_frame, seed=1, scale=1.0):
    """A refiner whose translation head spreads the hypotheses: a random
    kernel over the head's token-mean features of the first iteration,
    with the bias that centers it, so each hypothesis moves its own way
    (a plain random head moves them all alike)."""
    rp, sp = jax.tree.map(np.asarray, still[0]), still[1]
    te = _port(rp, sp)
    feats = []
    hook = te.refiner.trans_head[1].register_forward_hook(
        lambda m, i, o: feats.append(i[0].mean(dim=1).double()))
    te.register(K, *box_frame, iteration=1)
    hook.remove()
    F = feats[0].numpy()
    rng = np.random.default_rng(seed)
    Wk = rng.normal(size=(F.shape[1], 3)) * scale / (F.std(0).mean() * np.sqrt(F.shape[1]))
    rp["trans_head"]["1"]["kernel"] = Wk.astype(np.float32)
    rp["trans_head"]["1"]["bias"] = (-(F.mean(0) @ Wk)).astype(np.float32)
    return rp, sp


def test_register_recovery_checks_every_hypothesis(still, box_frame):
    """A fixed ADVICE finding: the JAX register checks only the winner's
    crop against the window. Here the winner stays inside while other
    valid hypotheses leave it (their refinement and scores read clipped
    crops); the JAX package keeps the windowed result, the port re-runs
    full-frame and gives the JAX package's register_roi=False pose."""
    rp, sp = _spreading_params(still, box_frame)
    je, te = _pair(rp, sp)
    roi = je._register_roi_window(K, box_frame[1], box_frame[2])
    je.register(K, *box_frame, iteration=1)
    assert je.register_roi_recoveries == 0
    P = np.asarray(je.poses, np.float64)
    valid = np.isfinite(np.asarray(je.scores))  # padded hypotheses score -inf, last
    inside = [j_contains(p, K, H, W, roi, je.diameter, 1.2) for p in P]
    assert inside[0] and not all(np.asarray(inside)[valid]), "the case needs an escaping non-winner"
    pt = te.register(K, *box_frame, iteration=1)
    assert te.register_roi_recoveries == 1
    # what the JAX register runs with register_roi=False: the packed
    # full-frame graph
    order, refined = jg.register_graph_packed(
        je.refiner_params, je.scorer_params, je.cfg, je.mesh_tensors, je.rot_grid, je.hyp_valid,
        jnp.asarray(K), jnp.asarray(jg.pack_register_frame(*box_frame)),
        jnp.float32(je.diameter), hw=(H, W), iterations=1)[:2]
    assert te.best_id == int(order[0])
    pj_full = np.asarray(refined[0], np.float64) @ je.get_tf_to_centered_mesh()
    np.testing.assert_allclose(pt, pj_full, atol=1e-4, rtol=0)


def test_register_window_covers_scorer_crop(live, box_frame):
    """A fixed ADVICE finding: the JAX package sizes the register window
    from the refiner's crop ratio alone, so a scorer with a wider crop
    reads past its edge. The port sizes it with the larger ratio: the
    window the JAX package would give a refiner of the scorer's ratio."""
    scorer_wide = {"scorer": dataclasses.replace(_cfgs("depth")[1].scorer, crop_ratio=1.6)}
    te = _port(*live, register_roi_margin=1.2, **scorer_wide)
    jc = dataclasses.replace(_cfgs("depth")[0], register_pack=True, register_roi=True,
                             register_roi_margin=1.2)

    def jax_window(cfg):  # the JAX method reads only cfg and diameter
        est = types.SimpleNamespace(cfg=cfg, diameter=te.diameter)
        return JPose._register_roi_window(est, K, box_frame[1], box_frame[2])

    got = te._register_roi_window(K, box_frame[1], box_frame[2])
    wide = jax_window(dataclasses.replace(jc, refiner=dataclasses.replace(jc.refiner, crop_ratio=1.6)))
    assert got == wide and got[2] > jax_window(jc)[2]
