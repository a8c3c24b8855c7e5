"""The port's attention core against foundationpose_tpu/ops/attention.py.

`attention_core_plain` is the plain version the CUDA kernel
(csrc/attention.cu) is held against on the card; here it is compared
with the JAX XLA core in f32 and with the Pallas kernel (interpret mode)
in bf16, at the shapes of tests/test_attention.py. The bf16 kernel's own
schedule (64-key tiles, two passes, weights normalized then rounded) is
replayed in torch and held against the Pallas kernel too.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from foundationpose_tpu.ops.attention import _attention_core_pallas, _attention_core_xla
from foundationpose_torch.ops import attention_cuda
from foundationpose_torch.ops.attention import attention_core, attention_core_plain


def _qkv(seed, B, L, D):
    return np.random.default_rng(seed).uniform(-1, 1, (B, L, 3 * D)).astype(np.float32)


@pytest.mark.parametrize("B,L,D,H", [(2, 24, 256, 2), (3, 37, 64, 4), (1, 20, 32, 4)])
def test_plain_matches_xla_f32(B, L, D, H):
    x = _qkv(0, B, L, D)
    ref = np.asarray(_attention_core_xla(jnp.asarray(x), H))
    out = attention_core_plain(torch.as_tensor(x), H).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "B,L,D,H",
    [
        (3, 400, 512, 4),  # refine/score head shape, batch shrunk
        (1, 252, 512, 4),  # scorer cross-attention
        (2, 20, 256, 2),  # padding: L=20 pads to 32 in the Pallas kernel
    ],
)
def test_plain_matches_pallas_bf16(B, L, D, H):
    x = jnp.asarray(_qkv(1, B, L, D), jnp.bfloat16)
    ref = np.asarray(_attention_core_pallas(x, H, interpret=True), np.float32)
    xt = torch.as_tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    out = attention_core_plain(xt, H)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= 2e-3  # one bf16 ulp below 0.5


def _kernel_schedule(qkv: torch.Tensor, num_heads: int, bk: int = 64) -> torch.Tensor:
    """The bf16 path of csrc/attention.cu step by step: the keys in tiles
    of `bk`, padded with zeros and masked to -inf at or past L; logits in
    f32 divided by sqrt(dh); pass 1 keeps a running row max m and the sum
    l rescaled at each new max; pass 2 forms exp(s - m) / l, rounds it to
    bf16 and adds P V tile by tile in f32."""
    B, L, threeD = qkv.shape
    D = threeD // 3
    dh = D // num_heads
    nt = -(-L // bk)
    x = qkv.to(torch.float32)

    def heads(t):
        return t.reshape(B, L, num_heads, dh).transpose(1, 2)

    q, k, v = (heads(t) for t in torch.split(x, D, dim=-1))
    pad = (0, 0, 0, nt * bk - L)
    k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    valid = torch.arange(nt * bk) < L

    def logits(t):
        s = q @ k[:, :, t * bk:(t + 1) * bk].transpose(-1, -2) / math.sqrt(dh)
        return torch.where(valid[t * bk:(t + 1) * bk], s, -torch.inf)

    m = torch.full((B, num_heads, L, 1), -torch.inf)
    l = torch.zeros((B, num_heads, L, 1))
    for t in range(nt):
        s = logits(t)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new
    o = torch.zeros((B, num_heads, L, dh))
    for t in range(nt):
        p = (torch.exp(logits(t) - m) / l).to(torch.bfloat16).to(torch.float32)
        o = o + p @ v[:, :, t * bk:(t + 1) * bk]
    return o.transpose(1, 2).reshape(B, L, D).to(torch.bfloat16)


@pytest.mark.parametrize("B,L,D,H", [(3, 400, 512, 4), (1, 252, 512, 4), (2, 20, 256, 2)])
def test_kernel_schedule_matches_pallas_bf16(B, L, D, H):
    x = jnp.asarray(_qkv(1, B, L, D), jnp.bfloat16)
    ref = np.asarray(_attention_core_pallas(x, H, interpret=True), np.float32)
    xt = torch.as_tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    out = _kernel_schedule(xt, H)
    assert out.dtype == torch.bfloat16 and out.shape == (B, L, D)
    assert np.abs(out.float().numpy() - ref).max() <= 2e-3
    # Normalizing before rounding leaves all but a few outputs bit-equal
    # to the Pallas kernel's; rounding unnormalized weights (a one-pass
    # online softmax) moves about half of them by an ulp.
    assert (out.float().numpy() != ref).mean() <= 0.01
    assert (out.float() - attention_core_plain(xt, H).float()).abs().max() <= 2e-3


def test_cpu_dispatch_is_plain_and_launches_nothing():
    x = torch.as_tensor(_qkv(2, 2, 16, 64))
    before = attention_cuda.KERNEL.launches
    assert torch.equal(attention_core(x, 4), attention_core_plain(x, 4))
    assert attention_cuda.KERNEL.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.attention_core_cuda(torch.zeros(1, 4, 24), 2)
