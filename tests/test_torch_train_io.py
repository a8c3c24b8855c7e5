"""The port's training I/O: the HDF5 pair readers (a copy of
foundationpose_tpu/datasets/h5_pairs.py) against the JAX package's on the
file tests/test_readers.py writes, bit-equal; and train-state
checkpoints (utils/checkpoint.py): training resumed from a checkpoint is
bit-equal to training without the break.
"""
import os

import numpy as np
import pytest
import torch

from foundationpose_torch.models import networks as tnet
from foundationpose_torch.models import training as ttr
from foundationpose_torch.utils.checkpoint import latest_step, load_train_state, save_train_state

# ------------------------------------------------------------ H5 readers


def _h5(tmp_path):
    pytest.importorskip("h5py")
    from tests.test_readers import TestH5Datasets

    return TestH5Datasets()._make_h5(str(tmp_path / "pairs.h5"))


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["PairH5Dataset", "PoseRefinePairH5Dataset", "TripletH5Dataset",
                                  "ScoreMultiPairH5Dataset"])
def test_h5_readers_match_jax(tmp_path, name):
    from foundationpose_tpu.datasets import h5_pairs as jh5
    from foundationpose_torch.datasets import h5_pairs as th5

    f = _h5(tmp_path)
    dj, dt = getattr(jh5, name)(f), getattr(th5, name)(f)
    for attr in ("object_keys", "perturb_keys", "crop_ratio", "H_ori", "W_ori",
                 "trans_normalizer", "rot_normalizer"):
        assert getattr(dt, attr) == getattr(dj, attr), attr
    assert getattr(dt, "xyz_invalid_z", None) == getattr(dj, "xyz_invalid_z", None)
    assert len(dt) == len(dj) == 2
    for key_idx in range(2):
        for i in range(3):
            _assert_same(dt.load_pair(key_idx, i), dj.load_pair(key_idx, i))
    if hasattr(dj, "load_triplet"):
        for a, b in zip(dt.load_triplet(0, 0, 2), dj.load_triplet(0, 0, 2)):
            _assert_same(a, b)
    if hasattr(dj, "load_group"):
        gt_, gj = dt.load_group(1, max_pairs=2), dj.load_group(1, max_pairs=2)
        assert len(gt_) == len(gj) == 2
        for a, b in zip(gt_, gj):
            _assert_same(a, b)


def test_h5_encoded_images_match_jax(tmp_path):
    """PNG-encoded images (the reference's layout) through the lazily
    imported imageio, with the defaults of a group without metadata."""
    h5py = pytest.importorskip("h5py")
    imageio = pytest.importorskip("imageio.v2")
    import io

    from foundationpose_tpu.datasets import h5_pairs as jh5
    from foundationpose_torch.datasets import h5_pairs as th5

    rng = np.random.default_rng(1)

    def png(a):
        buf = io.BytesIO()
        imageio.imwrite(buf, a, format="png")
        return np.frombuffer(buf.getvalue(), np.uint8)

    path = str(tmp_path / "encoded.h5")
    with h5py.File(path, "w") as hf:
        p = hf.create_group("ob").create_group("i_perturb_0")
        p["rgbA"] = png(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8))
        p["rgbB"] = png(rng.integers(0, 255, (16, 16, 4), dtype=np.uint8))
        p["depthA"] = png(rng.integers(400, 900, (16, 16)).astype(np.uint16))
        p["depthB"] = png(rng.integers(400, 900, (16, 16)).astype(np.uint16))
        p["poseA"] = np.eye(4, dtype=np.float32).ravel()
        p["K"] = np.eye(3, dtype=np.float32)
    dj, dt = jh5.PairH5Dataset(path), th5.PairH5Dataset(path)
    assert (dt.crop_ratio, dt.H_ori, dt.rot_normalizer) == (dj.crop_ratio, dj.H_ori, dj.rot_normalizer)
    pair = dt.load_pair(0, 0)
    _assert_same(pair, dj.load_pair(0, 0))
    assert pair["rgbB"].shape == (16, 16, 3) and pair["depthA"].dtype == np.float32


# ------------------------------------------------------------ train state


def _net_and_opt(weight_decay=0.0):
    net = tnet.init_refine_net(tnet.RefineNetCfg(base_width=4), torch.Generator().manual_seed(0))
    cfg = ttr.TrainCfg(lr=1e-3, weight_decay=weight_decay, compute_dtype="float32")
    return net, ttr.make_optimizer(cfg, net, device="cpu"), cfg


def _batches(n_steps):
    g = torch.Generator().manual_seed(3)
    return [{"A": torch.rand((2, 32, 32, 6), generator=g), "B": torch.rand((2, 32, 32, 6), generator=g),
             "trans_target": torch.randn((2, 3), generator=g),
             "rot_target": torch.randn((2, 3), generator=g)} for _ in range(n_steps)]


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_resumed_training_is_bit_equal(tmp_path, weight_decay):
    """4 steps straight, against 2 steps, a checkpoint, a fresh net and
    optimizer loaded from it, and 2 more steps: losses and every tensor
    of the state (BN statistics and Adam's moments included) bit-equal."""
    batches = _batches(4)
    net_ref, opt_ref, cfg = _net_and_opt(weight_decay)
    straight = [ttr.refine_train_step(net_ref, opt_ref, cfg, b) for b in batches]

    net, opt, _cfg = _net_and_opt(weight_decay)
    for b in batches[:2]:
        ttr.refine_train_step(net, opt, cfg, b)
    save_train_state(str(tmp_path), 2, {"model": net.state_dict(), "optimizer": opt.state_dict()})
    net2, opt2, _cfg = _net_and_opt(weight_decay)
    step, state = load_train_state(str(tmp_path))
    assert step == 2
    net2.load_state_dict(state["model"])
    opt2.load_state_dict(state["optimizer"])
    resumed = [ttr.refine_train_step(net2, opt2, cfg, b) for b in batches[2:]]
    assert [float(x) for x in resumed] == [float(x) for x in straight[2:]]
    for (n, a), b in zip(net_ref.state_dict().items(), net2.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = opt_ref.state_dict()["state"], opt2.state_dict()["state"]
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_train_state_steps_and_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        load_train_state(d)
    for step in (3, 10, 7):
        save_train_state(d, step, {"step": step, "w": torch.full((2,), float(step))})
    assert sorted(os.listdir(d)) == ["step_0000003", "step_0000007", "step_0000010"]
    assert latest_step(d) == 10
    step, state = load_train_state(d)
    assert step == 10 and state["step"] == 10 and torch.equal(state["w"], torch.full((2,), 10.0))
    step, state = load_train_state(d, step=3)
    assert step == 3 and torch.equal(state["w"], torch.full((2,), 3.0))
