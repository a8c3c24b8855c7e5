"""The port's BOP readers and its run_bop driver against foundationpose_tpu
on the BOP-format scene tree of tests/test_bop_e2e.py (written to disk:
scene_camera.json, scene_gt.json, rgb/depth/mask_visib pngs, models/*.ply
and models_info.json with a symmetry).

Every getter of the port's IcbinReader equals the JAX reader's; the
port's `run_bop` runs the chain reader -> register -> YAML -> --score on
the CPU, gated as test_bop_e2e.py::test_run_bop_cli_end_to_end gates the
JAX driver.
"""
import numpy as np
import pytest

from foundationpose_tpu.datasets import readers as jreaders
from foundationpose_torch.datasets import readers as treaders
from test_bop_e2e import bop_tree  # noqa: F401  (the module-scoped scene tree)


def _scene(bop):
    return str(bop / "icbin" / "icbin_test_bop19" / "test" / "000001")


@pytest.fixture
def bop_dirs(bop_tree, monkeypatch):  # noqa: F811
    bop, gt, meshes = bop_tree
    monkeypatch.setattr(jreaders, "BOP_DIR", str(bop))
    monkeypatch.setattr(treaders, "BOP_DIR", str(bop))
    return bop, gt, meshes


def test_icbin_reader_matches_jax(bop_dirs):
    """Exact: intrinsics, colors, depths, masks (both mask types and a
    missing one), gt poses (with and without mask disambiguation),
    instance ids, symmetry transforms, meshes, diameters, id strings and
    the reader factory and scene globs."""
    bop, _gt, _meshes = bop_dirs
    scene = _scene(bop)
    jr, tr = jreaders.get_bop_reader(scene), treaders.get_bop_reader(scene)
    assert type(tr).__name__ == type(jr).__name__ == "IcbinReader"
    assert treaders.get_bop_video_dirs("icbin") == jreaders.get_bop_video_dirs("icbin") == [scene]
    assert tr.id_strs == jr.id_strs == ["000001", "000002"]
    assert tr.ob_ids == jr.ob_ids and tr.get_video_id() == jr.get_video_id() == 1
    assert tr.dataset_name == jr.dataset_name and len(tr) == len(jr)
    for ob_id in tr.ob_ids:
        np.testing.assert_array_equal(tr.symmetry_tfs[ob_id], jr.symmetry_tfs[ob_id])
        assert tr.get_model_diameter(ob_id) == jr.get_model_diameter(ob_id)
        mt, mj = tr.get_gt_mesh(ob_id), jr.get_gt_mesh(ob_id)
        np.testing.assert_array_equal(mt.vertices, mj.vertices)
        np.testing.assert_array_equal(mt.faces, mj.faces)
    assert len(tr.symmetry_tfs[2]) == 2  # the discrete 180-degree symmetry
    for i in range(len(tr)):
        np.testing.assert_array_equal(tr.get_K(i), jr.get_K(i))
        np.testing.assert_array_equal(tr.get_color(i), jr.get_color(i))
        np.testing.assert_array_equal(tr.get_depth(i), jr.get_depth(i))
        np.testing.assert_array_equal(tr.get_instance_ids_in_image(i),
                                      jr.get_instance_ids_in_image(i))
        for ob_id in tr.ob_ids:
            mt, mj = tr.get_mask(i, ob_id), jr.get_mask(i, ob_id)
            assert (mt is None) == (mj is None)
            if mt is None:
                continue
            np.testing.assert_array_equal(mt, mj)
            np.testing.assert_array_equal(tr.get_gt_pose(i, ob_id, mask=mt),
                                          jr.get_gt_pose(i, ob_id, mask=mj))
            np.testing.assert_array_equal(tr.get_gt_pose(i, ob_id), jr.get_gt_pose(i, ob_id))
            np.testing.assert_array_equal(tr.get_gt_poses(i, ob_id), jr.get_gt_poses(i, ob_id))
    assert tr.get_mask(1, 2) is None  # object 2 is absent from frame 2


def test_run_bop_cli_on_cpu(bop_dirs, tmp_path):
    """The port's driver, --device cpu, on the tree: every (frame, object)
    registered once, per-frame ADD-S < 6 cm, then --score with
    ADDS_AUC > 0.5 (the JAX driver's gates; no weights, so the depth
    scorer picks from the rotation grid)."""
    from foundationpose_torch.cli.run_bop import main
    from foundationpose_torch.utils.metrics import adds_err

    _bop, gt, meshes = bop_dirs
    argv = ["--dataset", "icbin", "--out", str(tmp_path / "res.yml"), "--est_refine_iter", "1",
            "--min_n_views", "4", "--inplane_step", "90", "--device", "cpu"]
    res = main(argv)
    by_ob = res["icbin"]["1"]
    assert set(by_ob) == {"1", "2"}
    assert set(by_ob["1"]) == {"000001", "000002"} and set(by_ob["2"]) == {"000001"}
    for (frame, ob_id), gt_pose in gt.items():
        pose = np.asarray(by_ob[str(ob_id)][f"{frame:06d}"])
        assert np.linalg.norm(pose[:2, 3] - gt_pose[:2, 3]) < 0.03, (frame, ob_id)
        assert abs(pose[2, 3] - gt_pose[2, 3]) < 0.08, (frame, ob_id)
        assert adds_err(pose, gt_pose, meshes[ob_id].vertices * 1e-3) < 0.06, (frame, ob_id)
    score = main(argv + ["--score"])
    assert score["n"] == 3 and score["ADDS_AUC"] > 0.5
    assert 0.0 <= score["ADD_AUC"] <= 1.0


def test_run_bop_defaults_to_the_card(bop_dirs, tmp_path, monkeypatch):
    """Without --device the estimator is asked for on cuda: with no card
    it raises, never falls back to the CPU; the aliases pin their
    dataset and pass --device on."""
    import torch

    from foundationpose_torch.cli import run_bop, run_linemod, run_ycb_video

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--out", str(tmp_path / "r.yml"), "--min_n_views", "4"]
    with pytest.raises(RuntimeError, match="cuda"):
        run_bop.main(["--dataset", "icbin"] + argv)
    seen = []
    monkeypatch.setattr(run_bop, "run_dataset", lambda args: seen.append(args) or {})
    run_linemod.main(argv + ["--device", "cpu"])
    run_ycb_video.main(["--dataset=lmo"] + argv)
    assert [(a.dataset, a.device) for a in seen] == [("lm", "cpu"), ("lmo", "cuda")]
