"""Package-level properties of foundationpose_torch: it never imports
JAX, CPU tensors take the plain paths without launching a kernel, and
asking for CUDA without a card raises."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_register_script() -> str:
    return textwrap.dedent(
        """
        import sys
        import numpy as np
        import torch
        from foundationpose_torch.meshio import make_box
        from foundationpose_torch.models import (
            RefineNetCfg, ScoreNetCfg, init_refine_net, init_score_net)
        from foundationpose_torch.ops import raster_cuda, attention_cuda, render_mesh
        from foundationpose_torch.pipeline import (
            EstimatorCfg, FoundationPose, RefinerCfg, ScorerCfg)

        box = make_box(np.array([0.12, 0.16, 0.2]))
        box.vertex_colors = np.full((8, 3), 200, np.uint8)
        cfg = EstimatorCfg(
            refiner=RefinerCfg(net=RefineNetCfg(base_width=4), input_res=32),
            scorer=ScorerCfg(net=ScoreNetCfg(base_width=4), input_res=32, mode="network"),
            min_n_views=4, inplane_step_deg=120.0)
        K = np.array([[140.0, 0, 80.0], [0, 140.0, 60.0], [0, 0, 1.0]], np.float32)
        gt = np.eye(4, dtype=np.float32)
        gt[:3, 3] = [0.01, -0.02, 0.85]
        fr = render_mesh(
            torch.as_tensor(box.vertices, dtype=torch.float32), torch.as_tensor(box.faces),
            torch.as_tensor(gt[None]), torch.as_tensor(K), out_hw=(120, 160),
            vertex_color=torch.full((8, 3), 0.8),
            vnormals=torch.as_tensor(box.vertex_normals, dtype=torch.float32))
        rn = init_refine_net(cfg.refiner.net, torch.Generator().manual_seed(0))
        for head in (rn.trans_head, rn.rot_head):
            torch.nn.init.zeros_(head[1].weight)
            torch.nn.init.zeros_(head[1].bias)
        est = FoundationPose(
            mesh=box, cfg=cfg, refiner_params=rn,
            scorer_params=init_score_net(cfg.scorer.net, torch.Generator().manual_seed(1)),
            device="cpu")
        pose = est.register(K, (fr.color[0].numpy() * 255).astype(np.uint8),
                            fr.depth[0].numpy(), fr.mask[0].numpy().astype(np.uint8),
                            iteration=1)
        assert np.isfinite(pose).all() and abs(pose[2, 3] - 0.85) < 0.2, pose
        assert raster_cuda.KERNEL.launches == 0 and attention_cuda.KERNEL.launches == 0
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        assert "foundationpose_tpu" not in sys.modules
        print("OK")
        """
    )


def test_cpu_register_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _tiny_register_script()],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def _assert_no_jax_imports(paths):
    for path in paths:
        with open(path) as fh:
            src = fh.read()
        for banned in ("import jax", "from jax", "import foundationpose_tpu", "from foundationpose_tpu"):
            assert banned not in src, (path, banned)


def test_package_sources_import_no_jax():
    """Neither the package (every subpackage, the checkpoint, dataset and
    command-line ones included) nor chip_smoke.py imports JAX or the JAX
    package."""
    root = os.path.join(REPO, "foundationpose_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(root):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    walked = {os.path.relpath(p, root) for p in paths}
    for sub in ("utils/checkpoint.py", "utils/metrics.py", "datasets/readers.py",
                "cli/run_bop.py", "cli/run_demo.py", "models/loading.py",
                "models/reference_config.py", "geometry/symmetry.py", "pipeline/multi.py",
                "utils/vis.py", "cli/run_multi_demo.py", "models/training.py",
                "datasets/synthetic.py", "datasets/h5_pairs.py", "cli/run_nerf.py",
                "parallel/__init__.py", "parallel/sharding.py", "utils/debug_vis.py",
                "utils/profiling.py", "utils/misc.py", "cli/convert_weights.py",
                "examples/synthetic_end_to_end.py"):
        assert sub in walked, sub
    _assert_no_jax_imports(paths)


def test_cli_and_readers_import_without_jax_cv2_imageio_yaml():
    """The BOP driver, the readers, the checkpoint loaders and the training
    path (train steps, synthetic batches, the H5 pair readers, train-state
    checkpoints), the model-free entry point, convert_weights, the
    sharding and the profiling and misc helpers import with jax, cv2, imageio, yaml and h5py blocked:
    each is imported only where it is used (yaml where a result file or a
    sidecar config.yml is read, h5py and imageio where an H5 file is)."""
    script = textwrap.dedent(
        """
        import sys

        BLOCKED = ("jax", "cv2", "imageio", "yaml", "h5py", "foundationpose_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import foundationpose_torch.cli.run_bop
        import foundationpose_torch.cli.run_linemod
        import foundationpose_torch.cli.run_ycb_video
        import foundationpose_torch.datasets
        import foundationpose_torch.models.loading
        import foundationpose_torch.utils.metrics
        import foundationpose_torch.models.training
        import foundationpose_torch.datasets.synthetic
        import foundationpose_torch.datasets.h5_pairs
        import foundationpose_torch.cli.run_nerf
        import foundationpose_torch.cli.convert_weights
        import foundationpose_torch.parallel
        import foundationpose_torch.utils.misc
        import foundationpose_torch.utils.profiling
        from foundationpose_torch.utils.checkpoint import (
            latest_step, load_train_state, save_train_state)
        from foundationpose_torch.models.reference_config import load_reference_yaml
        try:
            load_reference_yaml("config.yml")
        except ImportError:
            pass
        else:
            raise AssertionError("a sidecar config.yml was read without yaml")
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_tracking_and_demo_clis_import_without_jax_cv2_imageio():
    """The tracking modules, the drawing helpers, the debug dumps, both
    demo drivers and the synthetic walkthrough import with jax, cv2 and
    imageio blocked: cv2 and imageio are imported where a frame is read
    or drawn."""
    script = textwrap.dedent(
        """
        import sys

        BLOCKED = ("jax", "cv2", "imageio", "foundationpose_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import foundationpose_torch.cli.run_demo
        import foundationpose_torch.cli.run_multi_demo
        import foundationpose_torch.utils.vis
        import foundationpose_torch.utils.debug_vis
        import foundationpose_torch.examples.synthetic_end_to_end
        from foundationpose_torch import MultiTracker as _M
        from foundationpose_torch.pipeline import MultiTracker, TrackResult, fetch_track_results
        from foundationpose_torch.pipeline.graph import TrackChain, track_chain_graph
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_card_tests_import_no_jax():
    """The card's tests run where JAX is not installed."""
    _assert_no_jax_imports([os.path.join(REPO, "tests", "test_torch_gpu.py")])


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from foundationpose_torch.meshio import make_box
    from foundationpose_torch.torch_config import default_device
    from foundationpose_torch.pipeline import FoundationPose

    assert default_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        default_device()
    with pytest.raises(RuntimeError, match="cuda"):
        FoundationPose(mesh=make_box(np.array([0.1, 0.1, 0.1])))


def test_tf32_is_off():
    import foundationpose_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_sources_and_build_key():
    """Every kernel is a CUDA source in the package, keyed by content; K3
    and K4 share segment_add.cu and so one library."""
    from foundationpose_torch.ops import attention_cuda, raster_cuda, segment_add_cuda
    from foundationpose_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR

    kernels = (raster_cuda.KERNEL, attention_cuda.KERNEL, segment_add_cuda.K3, segment_add_cuda.K4)
    for k in kernels:
        assert os.path.exists(os.path.join(CSRC_DIR, k.source))
        assert "arch=compute_90a,code=sm_90a" in k.flags
        path = k.path()
        assert path.startswith(BUILD_DIR) and path.endswith(".so")
    assert "--fmad=false" in raster_cuda.KERNEL.flags
    assert len({k.path() for k in kernels[:3]}) == 3
    assert segment_add_cuda.K3.path() == segment_add_cuda.K4.path()
    assert segment_add_cuda.K3.source == "segment_add.cu"
    with open(os.path.join(CSRC_DIR, "segment_add.cu")) as f:
        src = f.read()
    assert "atomicAdd" in src and "__float2bfloat16_rn" in src
    with open(os.path.join(CSRC_DIR, "attention.cu")) as f:
        src = f.read()
    # bf16 products on the tensor cores, operands through ldmatrix and cp.async
    for op in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", "ldmatrix", "cp.async"):
        assert op in src, op


def test_unsupported_device_raises():
    from foundationpose_torch.ops.attention import attention_core

    with pytest.raises(RuntimeError, match="no kernel"):
        attention_core(torch.zeros(1, 2, 12, device="meta"), 2)
