"""The port's model-free entry point, foundationpose_torch.cli.run_nerf:
on a reference-view tree written to disk (rgb/, depth/ in uint16 mm,
masks/, cam_in_ob/, K.txt) `run_nerf --device cpu` writes the mesh that
run_neural_object_field gives on the views it reads; the views read the
same through cv2 as through imageio; a bad preset is rejected; without
--device it asks for the card; it imports with jax, cv2 and imageio
blocked. A tiny NerfCfg stands in for the defaults."""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from foundationpose_torch import nerf as tnerf
from foundationpose_torch.cli import run_nerf
from foundationpose_torch.meshio import load_mesh
from foundationpose_torch.utils.vis import write_png
from test_torch_nerf import _port_box_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_rand=64, n_samples=8, n_samples_around_depth=8, num_levels=4, finest_res=64, log2_hashmap_size=12,
            mesh_resolution=0.03, tex_res=64, amp=False)


def _write_tree(root, K, rgbs, depths, masks, cam_in_obs):
    import cv2

    for sub in ("rgb", "depth", "masks", "cam_in_ob"):
        os.makedirs(f"{root}/{sub}", exist_ok=True)
    np.savetxt(f"{root}/K.txt", K)
    for i in range(len(rgbs)):
        name = f"{i:06d}"
        write_png(f"{root}/rgb/{name}.png", rgbs[i])
        cv2.imwrite(f"{root}/depth/{name}.png", np.round(depths[i] * 1e3).astype(np.uint16))
        cv2.imwrite(f"{root}/masks/{name}.png", (masks[i] > 0).astype(np.uint8) * 255)
        np.savetxt(f"{root}/cam_in_ob/{name}.txt", cam_in_obs[i])


@functools.lru_cache(maxsize=1)
def _scene():
    return _port_box_scene(32, 30.0)


@pytest.fixture
def tree(tmp_path):
    root = str(tmp_path / "ref")
    _write_tree(root, *_scene())
    return root


def test_run_nerf_cpu_writes_the_entry_points_mesh(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(tnerf, "NerfCfg", functools.partial(tnerf.NerfCfg, **TINY))
    out = str(tmp_path / "out")
    run_nerf.main(["--ref_view_dir", tree, "--n_step", "5", "--device", "cpu", "--out_dir", out])
    got = load_mesh(f"{out}/model.obj")
    rgbs, depths, masks, cam_in_obs, K = run_nerf.load_ref_views(tree)
    want, runner = tnerf.run_neural_object_field(
        tnerf.NerfCfg(n_step=5), K, rgbs, depths, masks, cam_in_obs, device="cpu")
    assert runner.global_step == 6 and len(want.faces) > 0
    assert got.faces.shape == want.faces.shape
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-6, rtol=0)
    assert got.texture is not None and got.texture.shape == want.texture.shape


def test_load_ref_views_cv2_matches_imageio(tree, monkeypatch):
    """Color through cv2 (BGR to RGB) where imageio is missing, as on the
    card's machine; depth in metres from uint16 millimetres."""
    rgbs, depths, masks, cam_in_obs, K = run_nerf.load_ref_views(tree)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    rgbs2, depths2, masks2, cam2, K2 = run_nerf.load_ref_views(tree)
    np.testing.assert_array_equal(rgbs2, rgbs)
    np.testing.assert_array_equal(depths2, depths)
    np.testing.assert_array_equal(masks2, masks)
    K0, rgbs0, depths0, masks0, cam0 = _scene()
    np.testing.assert_array_equal(rgbs, rgbs0)
    np.testing.assert_allclose(depths, depths0, atol=5e-4 + 1e-9, rtol=0)  # the mm quantum
    np.testing.assert_array_equal(masks, masks0)
    np.testing.assert_allclose(cam_in_obs, cam0, atol=1e-12, rtol=0)
    np.testing.assert_allclose(K, K0, atol=1e-12, rtol=0)


def test_run_nerf_rejects_a_bad_preset(tree):
    with pytest.raises(SystemExit):
        run_nerf.main(["--ref_view_dir", tree, "--preset", "turbo", "--device", "cpu"])


def test_run_nerf_defaults_to_the_card(tree, monkeypatch):
    """Without --device the field is asked for on cuda: with no card it
    raises before reading a view, never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    read = []
    monkeypatch.setattr(run_nerf, "load_ref_views", lambda d: read.append(d))
    with pytest.raises(RuntimeError, match="cuda"):
        run_nerf.main(["--ref_view_dir", tree])
    assert not read


def test_fast_preset_keeps_the_jax_overrides(tree, monkeypatch):
    seen = []
    monkeypatch.setattr(tnerf, "run_neural_object_field",
                        lambda cfg, *a, **kw: seen.append((cfg, kw)) or (_FakeMesh(), None))
    run_nerf.main(["--ref_view_dir", tree, "--preset", "fast", "--dataset", "linemod", "--device", "cpu",
                   "--n_step", "7", "--i_img", "3", "--artifact_dir", "a", "--out_dir", os.path.dirname(tree)])
    from foundationpose_tpu.nerf.config import LINEMOD_OVERRIDES, TPU_FAST_OVERRIDES

    cfg, kw = seen[0]
    want = dataclasses.replace(tnerf.NerfCfg(), **LINEMOD_OVERRIDES, **TPU_FAST_OVERRIDES, n_step=7)
    assert cfg == want
    assert tnerf.TPU_FAST_OVERRIDES == TPU_FAST_OVERRIDES and tnerf.LINEMOD_OVERRIDES == LINEMOD_OVERRIDES
    assert kw == dict(artifact_dir="a", i_img=3, i_mesh=500, device="cpu")


class _FakeMesh:
    vertices = np.zeros((0, 3))

    def export(self, path):
        pass


def test_run_nerf_imports_without_jax_cv2_imageio():
    script = textwrap.dedent(
        """
        import sys

        BLOCKED = ("jax", "cv2", "imageio", "sklearn", "foundationpose_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        from foundationpose_torch.cli import run_nerf
        try:
            run_nerf.main(["--help"])
        except SystemExit:
            pass
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
