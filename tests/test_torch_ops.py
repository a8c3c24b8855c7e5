"""Depth filters, the on-device translation guess and crop warps of
foundationpose_torch against foundationpose_tpu on the same inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from foundationpose_tpu.ops.depth_filters import (
    bilateral_filter_depth as j_bilateral,
    erode_depth as j_erode,
)
from foundationpose_tpu.ops.warp import warp_crop as j_warp_crop
from foundationpose_tpu.pipeline.graph import device_guess_translation as j_guess
from foundationpose_torch.ops.depth_filters import (
    bilateral_filter_depth as t_bilateral,
    erode_depth as t_erode,
)
from foundationpose_torch.ops.warp import warp_crop as t_warp_crop
from foundationpose_torch.pipeline.graph import device_guess_translation as t_guess


def _depth(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.6, 0.9, (h, w)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.15] = 0.0  # holes
    d[5:15, 10:30] += 0.05  # a step discontinuity
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_filters(seed):
    d = _depth(seed)
    ej = np.asarray(j_erode(jnp.asarray(d), radius=2))
    et = t_erode(torch.as_tensor(d), radius=2).numpy()
    np.testing.assert_allclose(et, ej, atol=1e-6, rtol=0)
    bj = np.asarray(j_bilateral(jnp.asarray(ej), radius=2))
    bt = t_bilateral(torch.as_tensor(ej), radius=2).numpy()
    np.testing.assert_allclose(bt, bj, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["object", "empty_mask", "one_pixel", "inf_depth", "all_inf",
                                  "ties"])
def test_device_guess_translation(case):
    d = _depth(2)
    mask = np.zeros(d.shape, np.uint8)
    if case == "object":
        mask[8:30, 12:40] = 1
    elif case == "one_pixel":
        mask[20, 20] = 1
        d[20, 20] = 0.75
    elif case == "inf_depth":  # +inf depths are valid: the top edges reach them
        mask[8:30, 12:40] = 1
        d[8:12, 12:40] = np.inf
    elif case == "all_inf":  # every valid depth +inf: NaN edges
        mask[8:30, 12:40] = 1
        d[8:30, 12:40] = np.inf
    elif case == "ties":  # a handful of distinct depths, each many times
        mask[8:30, 12:40] = 1
        d[8:30, 12:40] = np.round(d[8:30, 12:40], 1)
    K = np.array([[300.0, 0, 28.0], [0, 300.0, 20.0], [0, 0, 1.0]], np.float32)
    cj, nj = j_guess(jnp.asarray(d), jnp.asarray(mask), jnp.asarray(K))
    ct, nt = t_guess(torch.as_tensor(d), torch.as_tensor(mask), torch.as_tensor(K))
    assert int(nt) == int(nj)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_crop(mode):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    n = 6
    M = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    M[:, 0, 0] = M[:, 1, 1] = rng.uniform(0.5, 3.0, n)
    M[:, 0, 2] = rng.uniform(-60, 10, n)
    M[:, 1, 2] = rng.uniform(-40, 10, n)
    oj = np.asarray(j_warp_crop(jnp.asarray(img), jnp.asarray(M), (32, 32), mode=mode))
    ot = t_warp_crop(torch.as_tensor(img), torch.as_tensor(M), (32, 32), mode=mode).numpy()
    # the reference contracts at HIGH precision (~1.5e-5 relative)
    np.testing.assert_allclose(ot, oj, atol=1e-4, rtol=0)


def test_warp_crop_nearest_ties_resolve_as_reference():
    """Crop scales like 32/48 put nearest-mode source rows exactly on .5;
    the port's closed-form inverse rounds as jnp.linalg.inv does, so
    every tie goes the same way (bit-equal output)."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (60, 80, 3)).astype(np.float32)
    n = 16
    M = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    M[:, 0, 0] = M[:, 1, 1] = (32.0 / rng.integers(20, 60, n)).astype(np.float32)
    M[:, 0, 2] = -rng.integers(0, 40, n) * M[:, 0, 0]
    M[:, 1, 2] = -rng.integers(0, 30, n) * M[:, 1, 1]
    oj = np.asarray(j_warp_crop(jnp.asarray(img), jnp.asarray(M), (32, 32), mode="nearest"))
    ot = t_warp_crop(torch.as_tensor(img), torch.as_tensor(M), (32, 32), mode="nearest").numpy()
    np.testing.assert_array_equal(ot, oj)
