"""foundationpose_torch.geometry against foundationpose_tpu.geometry.

Same numpy inputs (fixed seeds) through the JAX function and its torch
port, f32 on both sides, atol 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from foundationpose_tpu.geometry import projection as jproj
from foundationpose_tpu.geometry import rotations as jrot
from foundationpose_tpu.geometry import transforms as jtf
from foundationpose_torch.geometry import projection as tproj
from foundationpose_torch.geometry import rotations as trot
from foundationpose_torch.geometry import transforms as ttf

ATOL = 1e-5


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=0)


def _poses(rng, n):
    R = np.asarray(jrot.so3_exp_map(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)))
    P = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    P[:, :3, :3] = R
    P[:, :3, 3] = rng.uniform([-0.1, -0.1, 0.5], [0.1, 0.1, 1.5], (n, 3))
    return P


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-5, 0.0])
def test_so3_exp_map(scale):
    w = (np.random.default_rng(0).normal(size=(16, 3)) * scale).astype(np.float32)
    _close(jrot.so3_exp_map(jnp.asarray(w)), trot.so3_exp_map(torch.as_tensor(w)))


@pytest.mark.parametrize("scale", [1.0, 1e-5])
def test_so3_log_map(scale):
    w = (np.random.default_rng(1).normal(size=(16, 3)) * scale).astype(np.float32)
    R = np.asarray(jrot.so3_exp_map(jnp.asarray(w)))
    _close(jrot.so3_log_map(jnp.asarray(R)), trot.so3_log_map(torch.as_tensor(R)))


def test_rotation_6d_roundtrip():
    d6 = np.random.default_rng(2).normal(size=(16, 6)).astype(np.float32)
    Rj = jrot.rotation_6d_to_matrix(jnp.asarray(d6))
    Rt = trot.rotation_6d_to_matrix(torch.as_tensor(d6))
    _close(Rj, Rt)
    _close(jrot.matrix_to_rotation_6d(Rj), trot.matrix_to_rotation_6d(Rt))


def test_euler_matrix():
    for ax, ay, az in [(0.3, -0.2, 1.1), (0.0, 0.0, 2.0), (-1.0, 0.5, 0.0)]:
        _close(jrot.euler_matrix(ax, ay, az), trot.euler_matrix(ax, ay, az))


def test_pose_algebra():
    rng = np.random.default_rng(3)
    P = _poses(rng, 8)
    dt = rng.normal(size=(8, 3)).astype(np.float32) * 0.01
    dR = np.asarray(jrot.so3_exp_map(jnp.asarray(rng.normal(size=(8, 3)) * 0.1, jnp.float32)))
    _close(
        jtf.egocentric_delta_pose_to_pose(jnp.asarray(P), jnp.asarray(dt), jnp.asarray(dR)),
        ttf.egocentric_delta_pose_to_pose(
            torch.as_tensor(P), torch.as_tensor(dt), torch.as_tensor(dR)
        ),
    )
    _close(jtf.invert_pose(jnp.asarray(P)), ttf.invert_pose(torch.as_tensor(P)))
    S = P.copy()
    S[:, :3, :3] *= rng.uniform(0.5, 2.0, (8, 1, 3)).astype(np.float32)
    _close(jtf.normalize_rotation(jnp.asarray(S)), ttf.normalize_rotation(torch.as_tensor(S)))
    pts = rng.normal(size=(8, 5, 3)).astype(np.float32)
    _close(
        jtf.transform_pts(jnp.asarray(pts), jnp.asarray(P)),
        ttf.transform_pts(torch.as_tensor(pts), torch.as_tensor(P)),
    )


def test_projection_and_xyz_map():
    rng = np.random.default_rng(4)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]], np.float32)
    pts = rng.uniform([-0.2, -0.2, 0.3], [0.2, 0.2, 2.0], (50, 3)).astype(np.float32)
    _close(
        jproj.project_points(jnp.asarray(pts), jnp.asarray(K)),
        tproj.project_points(torch.as_tensor(pts), torch.as_tensor(K)),
        atol=1e-3,  # pixels of magnitude ~1e3: 1e-5 relative
    )
    depth = rng.uniform(0.0, 2.0, (24, 32)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    for zfar in (np.inf, 1.5):
        _close(
            jproj.depth_to_xyz_map(jnp.asarray(depth), jnp.asarray(K), zfar=zfar),
            tproj.depth_to_xyz_map(torch.as_tensor(depth), torch.as_tensor(K), zfar=zfar),
        )


@pytest.mark.parametrize("round_box", [True, False])
def test_crop_window_tf(round_box):
    rng = np.random.default_rng(5)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]], np.float32)
    P = _poses(rng, 32)
    tj = jproj.compute_crop_window_tf(
        jnp.asarray(P), jnp.asarray(K), 1.2, 160, 0.2, round_box=round_box
    )
    tt = tproj.compute_crop_window_tf(
        torch.as_tensor(P), torch.as_tensor(K), 1.2, 160, 0.2, round_box=round_box
    )
    # translations are pixel-sized (~1e2-1e3): compare relatively
    np.testing.assert_allclose(np.asarray(tt), np.asarray(tj), rtol=1e-5, atol=ATOL)
    _close(jproj.invert_affine2d(tj), tproj.invert_affine2d(tt), atol=1e-3)


def test_guess_translation_host():
    rng = np.random.default_rng(6)
    K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]])
    depth = rng.uniform(0.5, 1.0, (120, 160)).astype(np.float32)
    mask = np.zeros((120, 160), np.uint8)
    mask[30:70, 50:110] = 1
    np.testing.assert_allclose(
        tproj.guess_translation(depth, mask, K), jproj.guess_translation(depth, mask, K)
    )
