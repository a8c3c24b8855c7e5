"""The trunks' first conv with its input channels zero-padded
(models/networks.py: `padded_channels`, `pad_pairs`, `_encode_pairs`;
models/layers.py: `Conv2d` pads its weight to the caller's `pad_to`). On a
card in bf16 the crops' 6 channels are padded so that cuDNN runs the conv
on its tensor cores; on the CPU and in f32 nothing is padded. Here the
padding path runs directly, in f32 on the CPU. Its card tests are in
tests/test_torch_gpu.py.
"""
import pytest
import torch

from foundationpose_torch.models import layers as L
from foundationpose_torch.models import networks as nets
from foundationpose_torch.utils import profiling


def _crops(n, res, c, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand((n, res, res, c), generator=gen) * 2 - 1 for _ in range(2)]


def _first_conv(c, seed=1):
    """A trunk's first ConvBNReLU (7x7, stride 2) with BN statistics away
    from the identity."""
    gen = torch.Generator().manual_seed(seed)
    layer = L.init_weights_(L.ConvBNReLU(c, 8, 7, 2, True), gen)
    bn = layer.net[1]
    with torch.no_grad():
        bn.running_mean.copy_(torch.rand(8, generator=gen) - 0.5)
        bn.running_var.copy_(torch.rand(8, generator=gen) + 0.2)
        bn.weight.copy_(torch.rand(8, generator=gen) + 0.5)
    return layer.eval()


@pytest.fixture
def recording():
    profiling.reset()
    profiling.enable()
    yield
    profiling.disable()
    profiling.reset()


@pytest.mark.parametrize("c,dtype,device,want", [
    (6, torch.bfloat16, "cuda", 16), (6, torch.float16, "cuda:1", 16),
    (3, torch.bfloat16, "cuda", 16), (17, torch.bfloat16, "cuda", 24),
    (8, torch.bfloat16, "cuda", 8), (64, torch.bfloat16, "cuda", 64),
    (6, torch.float32, "cuda", 6), (6, torch.bfloat16, "cpu", 6),
])
def test_padded_channels(c, dtype, device, want):
    """Only a half-precision call on a card with a channel count that is
    not a multiple of 8 pads, to a multiple of 8 and at least
    MIN_PADDED_CHANNELS."""
    assert nets.padded_channels(c, dtype, torch.device(device)) == want


@pytest.mark.parametrize("c,c_pad", [(6, 16), (6, 8), (3, 16), (5, 24)])
def test_padded_conv_matches_unpadded(recording, c, c_pad):
    """pad_pairs' buffer through the first ConvBNReLU, its weight padded
    to the buffer's width by `pad_to`, in f32: the input holds A then B and zeros past c;
    the forward and the weight's gradient equal the unpadded conv's within
    1e-6 of their largest entry; the gradient reaches the parameter at its
    own shape; state_dict() keeps its shapes; the call is counted."""
    layer = _first_conv(c)
    shapes = {k: v.shape for k, v in layer.state_dict().items()}
    A, B = _crops(2, 16, c, 2)
    x = nets.pad_pairs(A, B, torch.float32, c_pad)
    assert x.shape == (4, 16, 16, c_pad)
    assert torch.equal(x[..., :c], torch.cat([A, B])) and not x[..., c:].any()

    def forward_and_grad(inp, pad_to=None):
        layer.zero_grad(set_to_none=True)
        y = layer(inp.permute(0, 3, 1, 2), torch.float32, pad_to=pad_to)
        y.square().sum().backward()
        return y.detach(), layer.net[0].weight.grad

    got, g_got = forward_and_grad(x, c_pad)
    assert profiling.counters().get("conv.channel_pad") == 1
    want, g_want = forward_and_grad(torch.cat([A, B]), c)
    assert profiling.counters().get("conv.channel_pad") == 1  # the unpadded call is not counted
    assert got.shape == want.shape == (4, 8, 8, 8)
    assert g_got.shape == g_want.shape == (8, c, 7, 7)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=1e-6 * float(g_want.abs().max()))
    assert {k: v.shape for k, v in layer.state_dict().items()} == shapes


@pytest.mark.parametrize("c,c_in", [(6, 16), (6, 8), (8, 6)])
def test_conv_raises_on_other_channels_without_pad_to(recording, c, c_in):
    """Only the caller's `pad_to` pads the weight: an input of another
    channel count than the weight's raises, as an unpadded conv does, and
    nothing is counted."""
    layer = _first_conv(c)
    x = torch.zeros((2, c_in, 16, 16))
    with pytest.raises(RuntimeError):
        layer(x, torch.float32)
    assert "conv.channel_pad" not in profiling.counters()


def _old_tokens(enc_a, enc_ab, A, B, embed_dim, dtype):
    """networks._tokens as it was before the channel pad."""
    n = A.shape[0]
    x = torch.cat([A, B], dim=0).to(dtype).permute(0, 3, 1, 2)
    x = nets._run(enc_a, x, dtype)
    ab = nets._run(enc_ab, torch.cat([x[:n], x[n:]], dim=1), dtype)
    tokens = ab.permute(0, 2, 3, 1).reshape(n, -1, embed_dim)
    pe = L.positional_embedding(embed_dim, tokens.shape[1], tokens.device).to(dtype)
    return tokens + pe


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cpu_forward_bit_equal_to_unpadded(recording, monkeypatch, dtype):
    """On the CPU nothing pads: RefineNet's and ScoreNetMultiPair's
    forwards are bit for bit those of the trunk before the channel pad,
    and no padded conv is counted."""
    gen = torch.Generator().manual_seed(3)
    refine = nets.init_refine_net(nets.RefineNetCfg(base_width=4), gen)
    score = nets.init_score_net(nets.ScoreNetCfg(base_width=4), gen)
    A, B = _crops(3, 32, 6, 4)

    def forward():
        out = refine(A, B, dtype=dtype)
        return out["trans"], out["rot"], score(A, B, dtype=dtype)

    with torch.inference_mode():
        got = forward()
        with monkeypatch.context() as mp:
            mp.setattr(nets, "_tokens", _old_tokens)
            want = forward()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert "conv.channel_pad" not in profiling.counters()
