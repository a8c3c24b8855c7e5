"""Neural object field model: SH direction encoding, per-frame pose
corrections and the NeRFSmall MLP, on torch tensors.

Port of foundationpose_tpu/nerf/model.py (reference
bundlesdf/nerf_helpers.py:25-64 FeatureArray/PoseArray, 68-151 SHEncoder,
277-355 NeRFSmall). The MLP is an nn.Module whose Linear layers hold the
JAX kernels transposed (models/convert.py::nerf_params_from_jax).

bf16 ("amp"): the JAX layer rounds once, after a bf16 x bf16 product
accumulated in f32 plus the f32 bias. The port multiplies the
bf16-rounded operands in f32 (TF32 is off, so the products are exact),
adds the bias and rounds to bf16; a bf16 linear followed by a bias add
would round twice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import torch_config  # noqa: F401
from ..geometry.rotations import hat, so3_exp_map

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = [1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396]
_C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435]


def sh_encode(dirs: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """Real spherical harmonics up to `degree` (<= 4): (..., 3) -> (..., deg^2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree > 3:
        out += [
            _C3[0] * y * (3 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    return torch.stack(out, dim=-1)


def se3_exp(trans: torch.Tensor, log_rot: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: (..., 3) translation and rotation tangents ->
    (..., 4, 4) (pytorch3d se3_exp_map with PoseArray's transpose)."""
    R = so3_exp_map(log_rot)
    theta2 = torch.sum(log_rot * log_rot, dim=-1)
    small = theta2 < 1e-8
    # double where: no NaN gradient at the all-zero initial pose
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    safe = torch.sqrt(theta2_safe)
    A = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / theta2_safe)
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe - torch.sin(safe)) / (safe * theta2_safe))
    K = hat(log_rot)
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    V = eye3 + A[..., None, None] * K + B[..., None, None] * (K @ K)
    t = (V @ trans[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)  # (..., 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose_array_matrices(data: torch.Tensor, max_trans: float, max_rot_deg: float) -> torch.Tensor:
    """(F, 6) raw params -> (F, 4, 4) per-frame corrections: tanh-bounded
    translation and rotation, frame 0 pinned to the identity."""
    theta = torch.tanh(data)
    trans = theta[:, :3] * max_trans
    rot = theta[:, 3:6] * max_rot_deg / 180.0 * math.pi
    Ts = se3_exp(trans, rot)
    eye = torch.eye(4, dtype=Ts.dtype, device=Ts.device)
    return torch.cat([eye[None], Ts[1:]])


def _lin(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in `dtype` -> dot + bias rounded once to `dtype`."""
    if dtype == torch.float32:
        return x @ layer.weight.T + layer.bias
    w = layer.weight.to(dtype).to(torch.float32)
    return (x.to(torch.float32) @ w.T + layer.bias).to(dtype)


class NerfMLP(nn.Module):
    """NeRFSmall: 2-layer sigma net + 3-layer color net (nerf_runner.py:223)."""

    def __init__(self, input_ch: int, input_ch_views: int, hidden: int = 64, geo_feat: int = 15):
        super().__init__()
        self.sigma = nn.ModuleList([nn.Linear(input_ch, hidden), nn.Linear(hidden, 1 + geo_feat)])
        self.color = nn.ModuleList(
            [
                nn.Linear(input_ch_views + geo_feat, hidden),
                nn.Linear(hidden, hidden),
                nn.Linear(hidden, 3),
            ]
        )

    def forward(self, emb: torch.Tensor, views: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """-> (..., 4): rgb logits (3) + sdf (1), f32."""
        h = F.relu(_lin(self.sigma[0], emb.to(dtype), dtype))
        h = _lin(self.sigma[1], h, dtype)
        sdf = h[..., 0:1].to(torch.float32)
        c = torch.cat([views.to(dtype), h[..., 1:]], dim=-1)
        c = F.relu(_lin(self.color[0], c, dtype))
        c = F.relu(_lin(self.color[1], c, dtype))
        rgb = _lin(self.color[2], c, dtype).to(torch.float32)
        return torch.cat([rgb, sdf], dim=-1)

    def sdf(self, emb: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """SDF-only query for mesh extraction (nerf_helpers.py:334-340)."""
        h = F.relu(_lin(self.sigma[0], emb.to(dtype), dtype))
        return _lin(self.sigma[1], h, dtype)[..., 0].to(torch.float32)


def init_nerf_mlp(input_ch: int, input_ch_views: int, generator: torch.Generator,
                  hidden: int = 64, geo_feat: int = 15) -> NerfMLP:
    """The JAX package's init (kernel U(+-sqrt(3/fan_in)), bias
    U(+-sqrt(1/fan_in)), first sigma-output bias 0.1 for a positive
    initial SDF, nerf_helpers.py:299), drawn from `generator` on the CPU."""
    mlp = NerfMLP(input_ch, input_ch_views, hidden, geo_feat)
    with torch.no_grad():
        for layer in list(mlp.sigma) + list(mlp.color):
            bound = math.sqrt(1.0 / layer.in_features)
            layer.weight.copy_((torch.rand(layer.weight.shape, generator=generator) * 2 - 1)
                               * bound * math.sqrt(3))
            layer.bias.copy_((torch.rand(layer.bias.shape, generator=generator) * 2 - 1) * bound)
        mlp.sigma[-1].bias[0] = 0.1
    return mlp
