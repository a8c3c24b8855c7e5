"""The port's tooling against foundationpose_tpu on the same numpy inputs:
the debug dumps (utils/debug_vis.py) and FoundationPose(debug=...),
warp_perspective(_batch), utils/profiling.py, utils/misc.py,
cli/convert_weights.py, the public names of geometry / meshio / the
package, and the synthetic walkthrough (examples/synthetic_end_to_end.py)
run on the CPU in a subprocess.

Tolerances, stated where used: the canvases and the converted files
bit-equal; the warps within 1e-5 (bilinear; tests/test_ops.py's warps
hold 1e-5 and 2e-5) and exact in nearest mode.
"""
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import foundationpose_torch
from foundationpose_tpu.ops import warp_perspective as j_warp
from foundationpose_tpu.ops import warp_perspective_batch as j_warp_batch
from foundationpose_tpu.utils import debug_vis as j_dbg
from foundationpose_tpu.utils import misc as j_misc
from foundationpose_torch.ops import warp_perspective as t_warp
from foundationpose_torch.ops import warp_perspective_batch as t_warp_batch
from foundationpose_torch.pipeline import FoundationPose as TPose
from foundationpose_torch.utils import debug_vis as t_dbg
from foundationpose_torch.utils import misc as t_misc
from foundationpose_torch.utils import profiling
from test_torch_pipeline import KF, _box, _cfgs, _frame, _params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ debug dumps


def test_crop_canvas_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(-0.2, 1.2, (5, 16, 16, 6)).astype(np.float32)
    b = rng.uniform(-0.2, 1.2, (5, 16, 16, 6)).astype(np.float32)
    b[1, ..., 5] = 0.3  # a flat depth crop
    np.testing.assert_array_equal(t_dbg.crop_canvas(a, b), j_dbg.crop_canvas(a, b))
    np.testing.assert_array_equal(t_dbg.crop_canvas(a, b, max_rows=2), j_dbg.crop_canvas(a, b, max_rows=2))


def test_debug_register_writes_canvases_and_posed_mesh(tmp_path):
    """debug=3 (tests/test_pipeline.py::test_debug_artifacts): the scorer
    canvas of the top hypotheses, one refiner canvas per iteration, the
    mesh under the returned pose; the pose is the debug-free register's,
    and vis_score.png is the crop canvas of the register's own crops."""
    from foundationpose_torch.meshio import load_mesh
    from foundationpose_torch.pipeline.crops import make_crop_inputs
    from foundationpose_torch.utils.vis import read_rgb

    box = _box()
    frame = _frame(box)
    _rp, _sp, tr, _ts = _params(head_scale=0.05)
    _jc, tc = _cfgs("depth")
    plain = TPose(mesh=box, cfg=tc, refiner_params=tr, device="cpu")
    est = TPose(mesh=box, cfg=tc, refiner_params=tr, device="cpu", debug=3, debug_dir=str(tmp_path))
    want = plain.register(KF, *frame, iteration=2)
    pose = est.register(KF, *frame, iteration=2)
    np.testing.assert_array_equal(pose, want)
    names = {"vis_score.png", "vis_refiner_iter0.png", "vis_refiner_iter1.png", "model_tf.obj"}
    assert names <= set(os.listdir(tmp_path))
    tf_mesh = load_mesh(str(tmp_path / "model_tf.obj"))
    v = box.vertices @ pose[:3, :3].T + pose[:3, 3]
    np.testing.assert_allclose(np.sort(tf_mesh.vertices, 0), np.sort(v, 0), atol=1e-4)
    K_t, rgb_t, xyz = t_dbg._frame(est, KF, frame[0], frame[1])
    cfg = est.cfg.scorer
    a, b, _ = make_crop_inputs(est.mesh_tensors, est.poses[:16], K_t, rgb_t, xyz, est._diam,
                               input_res=cfg.input_res, crop_ratio=cfg.crop_ratio,
                               normalize_xyz=cfg.normalize_xyz, invalid_z=cfg.xyz_invalid_z)
    np.testing.assert_array_equal(read_rgb(str(tmp_path / "vis_score.png")),
                                  j_dbg.crop_canvas(a.numpy(), b.numpy()))
    # the refiner's first canvas starts at the winner's rotation at the guess
    assert est._guess_center.shape == (3,) and np.isfinite(est._guess_center).all()


def test_debug_below_2_writes_nothing(tmp_path):
    box = _box()
    _jc, tc = _cfgs("depth")
    est = TPose(mesh=box, cfg=tc, device="cpu", debug=1, debug_dir=str(tmp_path))
    est.register(KF, *_frame(box), iteration=1)
    assert os.listdir(tmp_path) == []


def test_run_demo_passes_debug(tmp_path):
    import types

    from foundationpose_torch.cli.run_demo import build_estimator

    args = types.SimpleNamespace(refiner_ckpt=None, scorer_ckpt=None, device="cpu", debug=2,
                                 debug_dir=str(tmp_path))
    est = build_estimator(_box(), args)
    assert (est.debug, est.debug_dir) == (2, str(tmp_path))


# ------------------------------------------------------------------ warps


def _warp_cases():
    """tests/test_ops.py's warp cases (identity, nearest translation, 2x
    scale, out of bounds, per-image shifts), a general homography, and
    tests/test_ops.py's crop transforms."""
    rng = np.random.default_rng(1)
    cases = []
    img = rng.uniform(0, 1, (12, 12, 3)).astype(np.float32)
    cases.append((img, np.eye(3, dtype=np.float32)[None], (12, 12), "bilinear"))
    one = np.zeros((8, 8, 1), np.float32)
    one[2, 3] = 7.0
    M = np.eye(3, dtype=np.float32)
    M[0, 2], M[1, 2] = 2.0, 1.0
    cases.append((one, M[None], (8, 8), "nearest"))
    cases.append((rng.uniform(0, 1, (6, 6, 2)).astype(np.float32),
                  np.diag([2.0, 2.0, 1.0]).astype(np.float32)[None], (12, 12), "bilinear"))
    far = np.eye(3, dtype=np.float32)
    far[0, 2] = 100.0
    cases.append((np.ones((4, 4, 1), np.float32), far[None], (4, 4), "bilinear"))
    H = np.array([[[1.1, 0.2, -1.0], [0.1, 0.9, 2.0], [0.001, 0.002, 1.0]]], np.float32)
    crops = np.array([[[2.0, 0, -4.0], [0, 2.0, -6.0], [0, 0, 1]], [[0.5, 0, 3.0], [0, 0.75, 1.0], [0, 0, 1]],
                      [[1.7, 0, -2.0], [0, 1.3, 0.5], [0, 0, 1]]], np.float32)
    src = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    for mode in ("bilinear", "nearest"):
        cases.append((src, np.concatenate([H, crops]), (16, 16), mode))
    return cases


@pytest.mark.parametrize("case", range(6))
def test_warp_perspective_matches_jax(case):
    img, M, hw, mode = _warp_cases()[case]
    want = np.asarray(j_warp(jnp.asarray(img), jnp.asarray(M), hw, mode=mode))
    got = t_warp(torch.as_tensor(img), torch.as_tensor(M), hw, mode=mode).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0 if mode == "nearest" else 1e-5, rtol=0)
    if case == 1:
        assert got[0, 3, 5, 0] == 7.0
    if case == 3:
        assert (got == 0).all()


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_perspective_batch_matches_jax(mode):
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 1, (4, 10, 12, 3)).astype(np.float32)
    M = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    M[:, 0, 2] = [0.0, 1.0, -1.0, 0.5]
    M[3, :2, :2] = [[1.2, 0.1], [-0.1, 0.9]]
    want = np.asarray(j_warp_batch(jnp.asarray(imgs), jnp.asarray(M), (10, 10), mode=mode))
    got = t_warp_batch(torch.as_tensor(imgs), torch.as_tensor(M), (10, 10), mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=0 if mode == "nearest" else 1e-5, rtol=0)
    for i in range(4):
        one = t_warp(torch.as_tensor(imgs[i]), torch.as_tensor(M[i : i + 1]), (10, 10), mode=mode)
        np.testing.assert_allclose(got[i], one[0].numpy(), atol=2e-5, rtol=0)


# -------------------------------------------------------- profiling, misc


def test_stage_timer_and_report():
    profiling.timing_report(reset=True)
    with profiling.stage_timer("unit", sync=False):
        time.sleep(0.01)
    with profiling.stage_timer("unit"):
        pass
    rep = profiling.timing_report(reset=True)
    assert rep["unit"]["count"] == 2 and rep["unit"]["total_s"] >= 0.01
    assert rep["unit"]["mean_ms"] == pytest.approx(1000 * rep["unit"]["total_s"] / 2)
    assert profiling.timing_report() == {}
    with pytest.raises(ZeroDivisionError):  # the block's exception is not swallowed
        with profiling.stage_timer("bad"):
            1 / 0
    assert "bad" not in profiling.timing_report(reset=True)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), name="unit") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "unit.json"
    assert path.exists() and "aten::mm" in path.read_text()
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_misc_matches_jax():
    rle = {"size": [3, 4], "counts": [2, 3, 4, 3]}
    np.testing.assert_array_equal(t_misc.rle_to_mask(rle), j_misc.rle_to_mask(rle))
    d = {"a": np.arange(3), "b": {"c": np.float32(1.5), "d": [np.int64(2), (np.ones(2),)]}, "e": "x"}
    assert t_misc.make_yaml_dumpable(d) == j_misc.make_yaml_dumpable(d)
    t_misc.set_seed(5)
    a = (np.random.rand(), torch.rand(1).item())
    t_misc.set_seed(5)
    assert (np.random.rand(), torch.rand(1).item()) == a


# ---------------------------------------------------------- public names


def test_public_names_match_jax():
    """The port's __init__s export every public name the JAX ones do,
    and the new geometry and meshio names compute the same."""
    import foundationpose_tpu
    import foundationpose_tpu.geometry as jg
    import foundationpose_tpu.meshio as jm
    import foundationpose_tpu.ops as jo
    import foundationpose_tpu.parallel as jp
    import foundationpose_torch.geometry as tg
    import foundationpose_torch.meshio as tm
    import foundationpose_torch.ops as to
    import foundationpose_torch.parallel as tp
    import foundationpose_tpu.models as jmo
    import foundationpose_tpu.utils as ju
    import foundationpose_torch.models as tmo
    import foundationpose_torch.utils as tu

    for jmod, tmod in ((jg, tg), (jo, to), (jp, tp), (jmo, tmo), (ju, tu)):
        names = {n for n in dir(jmod) if not n.startswith("_") and not isinstance(getattr(jmod, n), type(os))}
        assert names <= set(dir(tmod)), names - set(dir(tmod))
    assert foundationpose_torch.MultiTracker is foundationpose_torch.pipeline.MultiTracker
    assert foundationpose_torch.FoundationPose is TPose and hasattr(foundationpose_tpu, "MultiTracker")
    a = np.array([0.3, -1.2, 2.5], np.float32)
    for name in ("rot_x", "rot_y", "rot_z"):
        np.testing.assert_allclose(getattr(tg, name)(torch.as_tensor(a)).numpy(),
                                   np.asarray(getattr(jg, name)(jnp.asarray(a))), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tg.GLCAM_IN_CVCAM, jg.GLCAM_IN_CVCAM)
    np.testing.assert_array_equal(tg.projection_matrix_from_intrinsics(KF, 120, 160, 0.1, 10.0),
                                  jg.projection_matrix_from_intrinsics(KF, 120, 160, 0.1, 10.0))
    box = _box()
    np.testing.assert_array_equal(tm.add_pure_colored_texture(box, (9, 8, 7)).vertex_colors,
                                  jm.add_pure_colored_texture(box, (9, 8, 7)).vertex_colors)
    _rp, _sp, tr, ts = _params(head_scale=1.0)
    A = torch.rand((2, 32, 32, 6), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = tmo.apply_refine_net(tr, tr.cfg, A, A, dtype=torch.float32)
        assert torch.equal(got["rot"], tr(A, A, dtype=torch.float32)["rot"])
        assert torch.equal(tmo.apply_score_net(ts, ts.cfg, A, A), ts(A, A))
    with pytest.raises(ValueError):
        tmo.apply_refine_net(tr, tmo.RefineNetCfg(base_width=8), A, A)


def test_export_ply_matches_jax(tmp_path):
    import foundationpose_tpu.meshio as jm
    import foundationpose_torch.meshio as tm

    box = _box()
    for mesh in (box, tm.TriMesh(vertices=box.vertices, faces=box.faces)):
        tm.export_ply(mesh, str(tmp_path / "t.ply"))
        jm.export_ply(mesh, str(tmp_path / "j.ply"))
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        back = tm.load_ply(str(tmp_path / "t.ply"))
        np.testing.assert_allclose(back.vertices, mesh.vertices, atol=1e-7)


# ---------------------------------------------------------- convert_weights


def test_convert_weights_matches_jax(tmp_path):
    """A reference refiner .pth with its config.yml and a scorer .pth
    without one, through both packages' convert_weights: the same .npz
    arrays and meta, bit-equal, and both packages' loaders read the
    port's files as they read the JAX package's."""
    from foundationpose_tpu.cli.convert_weights import main as j_convert
    from foundationpose_tpu.models.loading import load_estimator_checkpoint as j_load
    from foundationpose_torch.cli.convert_weights import main as t_convert
    from foundationpose_torch.models.loading import load_estimator_checkpoint as t_load
    from foundationpose_torch.utils.checkpoint import load_params_meta
    from test_torch_estimator_io import _write_pth

    cfg_yaml = {"c_in": 6, "use_BN": True, "normalize_xyz": True, "crop_ratio": 1.4, "rot_rep": "6d",
                "input_resize": [160, 160], "zfar": "Infinity"}
    ref, _ = _write_pth(str(tmp_path / "ref"), "refiner", True, 6, cfg_yaml, extra_pe=True)
    sco, _ = _write_pth(str(tmp_path / "sco"), "scorer", False, 3, None)
    args = ["--refiner_ckpt", ref, "--scorer_ckpt", sco]
    t_convert(args + ["--out_dir", str(tmp_path / "t")])
    j_convert(args + ["--out_dir", str(tmp_path / "j")])
    for kind in ("refiner", "scorer"):
        tp, jp = str(tmp_path / "t" / f"{kind}.npz"), str(tmp_path / "j" / f"{kind}.npz")
        with np.load(tp) as a, np.load(jp) as b:
            assert set(a.files) == set(b.files)
            for k in b.files:
                if k != "__meta_json__":
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert load_params_meta(tp)[1] == load_params_meta(jp)[1]
        assert load_params_meta(tp)[1]["kind"] == kind
        jt, jcfg, jz = j_load(tp, kind)
        jj, jcfg2, jz2 = j_load(jp, kind)
        assert jcfg == jcfg2 and jz == jz2
        flat = lambda tree, pre="": {f"{pre}{k}": v for kk, vv in tree.items()  # noqa: E731
                                     for k, v in (flat(vv, f"{kk}/").items() if isinstance(vv, dict)
                                                  else [(kk, vv)])}
        for k, v in flat(jj).items():
            np.testing.assert_array_equal(np.asarray(flat(jt)[k]), np.asarray(v), err_msg=k)
        ts, tcfg, tz = t_load(tp, kind)
        ts2, _tcfg2, _ = t_load(jp, kind)
        assert tz == jz and tcfg.net.use_bn == (kind == "refiner")
        assert all(torch.equal(ts[k], ts2[k]) for k in ts2)
    assert load_params_meta(str(tmp_path / "t" / "refiner.npz"))[1]["reference_config"]["crop_ratio"] == 1.4


def test_convert_weights_error_paths(tmp_path):
    """tests/test_cli.py's: no checkpoint exits; so do a scorer given as
    the refiner and a config whose use_BN contradicts the weights."""
    from foundationpose_torch.cli.convert_weights import main
    from test_torch_estimator_io import _write_pth

    with pytest.raises(SystemExit):
        main(["--out_dir", str(tmp_path)])
    sco, _ = _write_pth(str(tmp_path / "sco"), "scorer", False, 3, None)
    with pytest.raises(SystemExit, match="holds a scorer"):
        main(["--refiner_ckpt", sco, "--out_dir", str(tmp_path / "o")])
    ref, _ = _write_pth(str(tmp_path / "ref"), "refiner", False, 3,
                        {"c_in": 6, "use_BN": True, "input_resize": [160, 160]})
    with pytest.raises(SystemExit, match="use_BN"):
        main(["--refiner_ckpt", ref, "--out_dir", str(tmp_path / "o")])


# ---------------------------------------------------------- the walkthrough


# The walkthrough's main() with 32 px crops in place of its 160 px (the
# brute CPU raster makes 160 px crops take minutes here): RefinerCfg and
# ScorerCfg default to input_res 32 in the subprocess, nothing else moves.
_WALKTHROUGH = """
import functools, sys
import foundationpose_torch.pipeline as p
p.RefinerCfg = functools.partial(p.RefinerCfg, input_res=32)
p.ScorerCfg = functools.partial(p.ScorerCfg, input_res=32)
from foundationpose_torch.examples.synthetic_end_to_end import main
main(sys.argv[1:])
"""


def test_synthetic_walkthrough_runs_on_the_cpu():
    """examples/synthetic_end_to_end.py's counterpart, --device cpu, two
    frames at 32 px crops: both objects registered and tracked by one
    MultiTracker, finite ADD-S for every frame, the JAX walkthrough's
    numbers on this scene (24.0 / 74.2 mm at frame 0, its crops are 160
    px; within 20 mm here)."""
    out = subprocess.run(
        [sys.executable, "-c", _WALKTHROUGH, "--device", "cpu", "--frames", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=400,
        # two threads: the suite's workers share the cores with it
        env=dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2"),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "done." and any("MultiTracker" in ln for ln in lines)
    errs = [float(ln.split("=")[1].split()[0]) for ln in lines if "object" in ln and "ADD-S" in ln]
    assert len(errs) == 2 and np.isfinite(errs).all()
    assert abs(errs[0] - 24.0) < 20 and abs(errs[1] - 74.2) < 20, errs
    frame1 = [ln for ln in lines if ln.strip().startswith("frame  1")]
    assert len(frame1) == 1
