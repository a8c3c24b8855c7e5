"""The port's synthetic training batches and delta targets
(foundationpose_torch/datasets/synthetic.py, geometry/transforms.py)
against foundationpose_tpu on the same draws.

The port draws from a torch.Generator, whose streams differ from
jax.random's; its bodies take `draws=`, and here they get the values the
JAX functions' jax.random calls produce (the same split layout). The JAX
side renders with the brute rasterizer (its "auto" picks the binned one
on the CPU, which drops faces). Tolerances: rendered crops 2e-4 (the
renderer's criterion, tests/test_torch_pipeline.py), warped observation
crops 1e-4, poses, targets and ADD 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.datasets import synthetic as jsyn
from foundationpose_tpu.geometry import transforms as jtf
from foundationpose_tpu.models.networks import RefineNetCfg as JRNet
from foundationpose_tpu.models.networks import ScoreNetCfg as JSNet
from foundationpose_tpu.pipeline import RasterCfg as JRaster
from foundationpose_tpu.pipeline import RefinerCfg as JRef
from foundationpose_tpu.pipeline import ScorerCfg as JSco
from foundationpose_tpu.pipeline import make_mesh_tensors as j_mesh
from foundationpose_torch.datasets import synthetic as tsyn
from foundationpose_torch.geometry import transforms as ttf
from foundationpose_torch.geometry.rotations import so3_exp_map, so3_log_map
from foundationpose_torch.models.networks import RefineNetCfg as TRNet
from foundationpose_torch.models.networks import ScoreNetCfg as TSNet
from foundationpose_torch.pipeline import RefinerCfg as TRef
from foundationpose_torch.pipeline import ScorerCfg as TSco
from foundationpose_torch.pipeline import make_mesh_tensors as t_mesh
from foundationpose_torch.pipeline.refiner import apply_pose_delta
from tests.test_pipeline import K, colored_box

POSE_TOL = 1e-5
RENDER_TOL = 2e-4
WARP_TOL = 1e-4
HW = (120, 160)


def _t(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def jax_pair_draws(key, n):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return _t({"w_gt": jax.random.normal(k1, (n, 3)), "t_gt": jax.random.normal(k2, (n, 3)),
               "dw": jax.random.normal(k3, (n, 3)), "dt": jax.random.normal(k4, (n, 3))})


def jax_refiner_draws(key, n, res, occlude_max_frac=None):
    """make_refiner_batch's draws: split(key, 3) -> pairs, unused, occluder."""
    k1, _k2, k_occ = jax.random.split(key, 3)
    draws = {"pairs": jax_pair_draws(k1, n)}
    if occlude_max_frac is not None:
        kc, kh, kp, kcol = jax.random.split(k_occ, 4)
        u = jax.random.uniform
        draws["occlude"] = _t({
            "center": u(kc, (n, 2), minval=0.1 * res, maxval=0.9 * res),
            "half": u(kh, (n, 2), minval=0.08 * res, maxval=occlude_max_frac * res / 2),
            "apply": u(kp, (n,)),
            "col": u(kcol, (n, 1, 1, 3), minval=0.05, maxval=0.9),
        })
    return draws


def jax_scorer_draws(key, n, scene_key=None, occlude_max_frac=None):
    """make_scorer_batch's draws: split(key, 4) -> scene (or scene_key),
    dw, dt, occluder."""
    k1, k2, k3, k_occ = jax.random.split(key, 4)
    if scene_key is not None:
        k1 = scene_key
    draws = {"scene": jax_pair_draws(k1, 1),
             **_t({"dw": jax.random.normal(k2, (n, 3)), "dt": jax.random.normal(k3, (n, 3))})}
    if occlude_max_frac is not None:
        kp, kc, kh, kcol = jax.random.split(k_occ, 4)
        u = jax.random.uniform
        draws["occlude"] = _t({
            "apply": u(kp, ()), "c": u(kc, (2,), minval=-0.6, maxval=0.6),
            "half": u(kh, (2,), minval=0.25, maxval=occlude_max_frac),
            "col": u(kcol, (3,), minval=0.05, maxval=0.9),
        })
    return draws


def _random_poses(rng, n):
    P = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    P[:, :3, :3] = so3_exp_map(torch.as_tensor(rng.normal(size=(n, 3)) * 1.5, dtype=torch.float32)).numpy()
    P[:, :3, 3] = rng.normal(size=(n, 3)) * 0.1 + [0, 0, 0.8]
    return P


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


# ------------------------------------------------------------ transforms


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    A, B = _random_poses(rng, 6), _random_poses(rng, 6)
    dt_t, dR_t = ttf.pose_to_egocentric_delta_pose(torch.as_tensor(A), torch.as_tensor(B))
    dt_j, dR_j = jtf.pose_to_egocentric_delta_pose(jnp.asarray(A), jnp.asarray(B))
    _close(dt_t, dt_j, 1e-6)
    _close(dR_t, dR_j, 1e-6)
    back = ttf.egocentric_delta_pose_to_pose(torch.as_tensor(A), dt_t, dR_t)
    _close(back, B, 1e-5)
    pts = rng.normal(size=(6, 5, 3)).astype(np.float32)
    _close(ttf.to_homo(torch.as_tensor(pts)), jtf.to_homo(jnp.asarray(pts)), 0)
    _close(ttf.transform_dirs(torch.as_tensor(pts), torch.as_tensor(A)),
           jtf.transform_dirs(jnp.asarray(pts), jnp.asarray(A)), 1e-6)
    # one transform per point row, and a batch of transforms over every point
    _close(ttf.transform_dirs(torch.as_tensor(pts[0]), torch.as_tensor(A[:2])),
           jtf.transform_dirs(jnp.asarray(pts[0]), jnp.asarray(A[:2])), 1e-6)


# ------------------------------------------------------------ targets


def _pairs_with_rotations(angles, trans):
    """poseA random; poseB = (R(axis, angle) @ R_A, t_A + trans)."""
    rng = np.random.default_rng(1)
    n = len(angles)
    A = _random_poses(rng, n)
    axes = rng.normal(size=(n, 3))
    axes[3:6] = np.eye(3)  # one component each on the clip's boundary
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    dR = so3_exp_map(torch.as_tensor(axes * np.asarray(angles)[:, None], dtype=torch.float32))
    B = A.copy()
    B[:, :3, :3] = dR.numpy() @ A[:, :3, :3]
    B[:, :3, 3] += np.asarray(trans, np.float32)
    return A, B


@pytest.mark.parametrize("normalize_xyz", [True, False])
def test_delta_targets_match_jax(normalize_xyz):
    """Near-pi rotations (so3_log_map's theta / (2 sin theta) branch) and
    rotations and translations on both sides of the +-0.999 clip."""
    rn = 0.34906585
    tn = np.array([0.02, 0.02, 0.05])
    angles = [0.1, math.pi - 1e-2, math.pi - 1e-3, 0.999 * rn, 0.9985 * rn, 0.9995 * rn, 1.2, 1e-5]
    trans = [tn * f for f in (0.5, 0.9985, 0.9995, 1.5, -0.9985, -0.9995, 0.0, 1e-4)]
    A, B = _pairs_with_rotations(angles, trans)
    jcfg = JRef(normalize_xyz=normalize_xyz)
    tcfg = TRef(normalize_xyz=normalize_xyz)
    tj, rj = jsyn.delta_targets(jnp.asarray(A), jnp.asarray(B), jcfg, jnp.float32(0.3))
    tt, rt = tsyn.delta_targets(torch.as_tensor(A), torch.as_tensor(B), tcfg, 0.3)
    _close(tt, tj, POSE_TOL)
    _close(rt, rj, POSE_TOL)
    sat = np.isclose(np.abs(np.asarray(rj)), np.arctanh(np.float32(0.999)), rtol=1e-6)
    assert sat[1:3].all() and sat[3, 0] and sat[5, 2] and not sat[4].any()


def test_targets_invert_apply():
    """apply_pose_delta(poseA, targets) gives poseB back: the generator
    and the inference delta are inverse maps (TestDeltaTargets)."""
    cfg = TRef(compute_dtype="float32")
    poseA, poseB = tsyn.sample_pose_pairs(torch.Generator().manual_seed(0), 8)
    trans_t, rot_t = tsyn.delta_targets(poseA, poseB, cfg, 0.3)
    rec = apply_pose_delta(poseA, trans_t, rot_t, cfg, 0.3)
    _close(rec, poseB.numpy(), 1e-4)


# ------------------------------------------------------------ pose pairs


def test_pose_pairs_from_jax_draws_match_jax():
    key = jax.random.PRNGKey(3)
    pj = jsyn.sample_pose_pairs(key, 8, rot_sigma=0.3, trans_sigma=0.02)
    pt = tsyn.sample_pose_pairs(None, 8, rot_sigma=0.3, trans_sigma=0.02,
                                draws=jax_pair_draws(key, 8))
    for t, j in zip(pt, pj):
        _close(t, j, POSE_TOL)


def test_pose_pairs_valid_and_distributed():
    """The port's own draws: orthonormal rotations in front of the camera
    (TestDeltaTargets.test_pose_pairs_valid), and the draws' means and
    spreads. n = 4096: a spread is off by 5% at ~3 standard errors."""
    n = 4096
    poseA, poseB = tsyn.sample_pose_pairs(torch.Generator().manual_seed(1), n,
                                          rot_sigma=0.2, trans_sigma=0.03)
    for P in (poseA.numpy(), poseB.numpy()):
        RtR = np.einsum("nij,nik->njk", P[:, :3, :3], P[:, :3, :3])
        np.testing.assert_allclose(RtR, np.tile(np.eye(3), (n, 1, 1)), atol=1e-5)
        assert (P[:, 2, 3] > 0.3).all()
    t = poseB[:, :3, 3].numpy()
    np.testing.assert_allclose(t.mean(0), [0, 0, 0.8], atol=0.01)
    np.testing.assert_allclose(t.std(0), [0.05, 0.05, 0.1], rtol=0.05)
    dt = (poseA - poseB)[:, :3, 3].numpy()
    np.testing.assert_allclose(dt.std(0), [0.03] * 3, rtol=0.05)
    np.testing.assert_allclose(dt.mean(0), [0] * 3, atol=0.003)
    dw = so3_log_map(poseA[:, :3, :3] @ poseB[:, :3, :3].transpose(-1, -2)).numpy()
    np.testing.assert_allclose(dw.std(0), [0.2] * 3, rtol=0.05)
    # isotropic rotations: their mean is a multiple of the identity
    M = poseB[:, :3, :3].numpy().mean(0)
    assert np.abs(M - np.diag(np.diag(M))).max() < 0.03


def test_key_is_a_seed_or_a_generator_on_the_batch_device():
    a = tsyn.sample_pose_pairs(5, 4, device="cpu")[0]
    b = tsyn.sample_pose_pairs(torch.Generator().manual_seed(5), 4)[0]
    assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tsyn.sample_pose_pairs(5, 4)
    with pytest.raises(ValueError, match="generator"):
        tsyn._generator(torch.Generator(), "meta")


# ------------------------------------------------------------ batches


def _box():
    mesh = colored_box()
    return mesh, j_mesh(mesh), t_mesh(mesh)


def _refiner_cfgs(res=32):
    jc = JRef(net=JRNet(base_width=4), compute_dtype="float32", input_res=res,
              raster=JRaster(method="brute"))
    tc = TRef(net=TRNet(base_width=4), compute_dtype="float32", input_res=res)
    return jc, tc


def _scorer_cfgs(res=32):
    jc = JSco(net=JSNet(base_width=4), input_res=res, mode="network", compute_dtype="float32",
              raster=JRaster(method="brute"))
    tc = TSco(net=TSNet(base_width=4), input_res=res, mode="network", compute_dtype="float32")
    return jc, tc


@pytest.mark.parametrize("occlude_prob", [0.0, 0.9])
def test_make_refiner_batch_matches_jax(occlude_prob):
    _mesh, mj, mt = _box()
    jc, tc = _refiner_cfgs()
    key = jax.random.PRNGKey(0)
    n = 8
    bj = jsyn.make_refiner_batch(key, mj, jnp.asarray(K), jc, jnp.float32(0.28), n=n,
                                 frame_hw=HW, occlude_prob=occlude_prob)
    bt = tsyn.make_refiner_batch(
        None, mt, torch.as_tensor(K), tc, 0.28, n=n, occlude_prob=occlude_prob,
        draws=jax_refiner_draws(key, n, 32, 0.5 if occlude_prob else None))
    for k in ("poseA", "poseB", "trans_target", "rot_target"):
        _close(bt[k], bj[k], POSE_TOL)
    _close(bt["A"], bj["A"], RENDER_TOL)
    _close(bt["B"], bj["B"], RENDER_TOL)  # B is a render here too
    assert bt["A"].shape == (n, 32, 32, 6) and bt["A"].dtype == torch.float32
    if occlude_prob:
        # the occluder's pixels: flat color, geometry zeroed, where JAX has them
        occ_j = np.asarray(bj["B"][..., 3:] == 0).all(-1)
        occ_t = (bt["B"][..., 3:] == 0).all(-1).numpy()
        assert (occ_j == occ_t).mean() > 0.999


@pytest.mark.parametrize("occlude_prob,max_frac", [(0.0, 0.7), (1.0, 0.35)])
def test_make_scorer_batch_matches_jax(occlude_prob, max_frac):
    _mesh, mj, mt = _box()
    jc, tc = _scorer_cfgs()
    key, scene_key = jax.random.PRNGKey(1), jax.random.PRNGKey(42)
    n = 8
    kw = dict(n=n, frame_hw=HW, occlude_prob=occlude_prob, occlude_max_frac=max_frac)
    bj = jsyn.make_scorer_batch(key, mj, jnp.asarray(K), jc, jnp.float32(0.28),
                                scene_key=scene_key, **kw)
    bt = tsyn.make_scorer_batch(
        None, mt, torch.as_tensor(K), tc, 0.28, **kw,
        draws=jax_scorer_draws(key, n, scene_key, max_frac if occlude_prob else None))
    for k in ("poses", "gt", "add", "target"):
        _close(bt[k], bj[k], POSE_TOL)
    _close(bt["A"], bj["A"], RENDER_TOL)
    _close(bt["B"], bj["B"], WARP_TOL)
    assert bt["target"].shape == (n,)
    if occlude_prob:  # a partial occluder: some of the object's geometry is left
        assert 0 < float((bt["B"][..., 3:] != 0).any(-1).float().mean()) < 0.5


def test_refiner_batch_occlusion():
    """occlude_prob corrupts only the observation branch: a flat-color
    rectangle with zeroed geometry; targets and the hypothesis branch
    untouched (TestOcclusionAugmentation)."""
    _mesh, _mj, mt = _box()
    _jc, tc = _refiner_cfgs()
    kw = dict(n=8)
    b0 = tsyn.make_refiner_batch(0, mt, torch.as_tensor(K), tc, 0.28, **kw)
    b1 = tsyn.make_refiner_batch(0, mt, torch.as_tensor(K), tc, 0.28, occlude_prob=0.9, **kw)
    assert float((b0["A"] - b1["A"]).abs().max()) == 0.0
    assert float((b0["B"] - b1["B"]).abs().max()) > 0.0
    assert torch.equal(b0["trans_target"], b1["trans_target"])
    diff = ((b0["B"][..., :3] - b1["B"][..., :3]).abs().sum(-1) > 1e-6).numpy()
    assert diff.any()
    assert (b1["B"][..., 3:].numpy()[diff] == 0).all()


def test_scorer_batch_occlusion_shared_and_label_free():
    """The scorer's occluder lives in frame space and never touches the
    ADD targets or the hypotheses (TestOcclusionAugmentation)."""
    _mesh, _mj, mt = _box()
    _jc, tc = _scorer_cfgs()
    kw = dict(n=8, frame_hw=HW)
    s0 = tsyn.make_scorer_batch(1, mt, torch.as_tensor(K), tc, 0.28, **kw)
    s1 = tsyn.make_scorer_batch(1, mt, torch.as_tensor(K), tc, 0.28, occlude_prob=1.0, **kw)
    assert float((s0["B"] - s1["B"]).abs().max()) > 0.0
    assert torch.equal(s0["target"], s1["target"])
    assert torch.equal(s0["poses"], s1["poses"])


def test_scene_seed_pins_the_gt_pose():
    _mesh, _mj, mt = _box()
    _jc, tc = _scorer_cfgs()
    kw = dict(n=4, frame_hw=HW, scene_seed=42)
    s0 = tsyn.make_scorer_batch(1, mt, torch.as_tensor(K), tc, 0.28, **kw)
    s1 = tsyn.make_scorer_batch(2, mt, torch.as_tensor(K), tc, 0.28, **kw)
    assert torch.equal(s0["gt"], s1["gt"])
    assert not torch.equal(s0["poses"][1:], s1["poses"][1:])
    # the first hypothesis is the gt pose itself (scale 0)
    _close(s0["poses"][0], s0["gt"].numpy(), 1e-6)
    assert float(s0["add"][0]) < 1e-6
