"""The layer epilogue (models/layers.py::epilogue) and its fused kernel
(ops/epilogue_cuda.py, csrc/epilogue.cu); torch only, no JAX.

CPU tests: the plain path is each layer's chain of ops as it ran before
the kernel, op for op; CPU tensors and calls under autograd take it, as
the recorder's path counters say; the wrapper refuses what it cannot take; and the
bytes register.epilogue_roofline counts are those the epilogues of one
RefineNet and one ScoreNet forward read and write. Card tests (marker
gpu, skipped without a card) hold the fused kernel bit-equal to the
plain path. On the card:
    python -m pytest --noconftest -m gpu tests/test_torch_epilogue.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from foundationpose_torch.models import layers as L
from foundationpose_torch.models import networks as nets
from foundationpose_torch.ops import epilogue_cuda
from foundationpose_torch.utils import profiling


def _old_forward(m, x, dtype):
    """Each layer's forward as it was before the epilogue kernel, op for op."""
    if isinstance(m, L.ConvBNReLU):
        for sub in m.net:
            x = _old_forward(sub, x, dtype)
        return x
    if isinstance(m, L.Conv2d):
        y = F.conv2d(x.to(dtype), m.weight.to(dtype), None, m.stride, m.padding)
        return L._add_bias(y, m.bias, (1, -1, 1, 1), dtype)
    if isinstance(m, L.Linear):
        return L._add_bias(F.linear(x.to(dtype), m.weight.to(dtype)), m.bias, (-1,), dtype)
    if isinstance(m, L.BatchNorm2d):
        return m(x)
    if isinstance(m, L.ReLU):
        return F.relu(x)
    if isinstance(m, L.ResnetBasicBlock):
        out = _old_forward(m.conv1, x, dtype)
        if m.bn1 is not None:
            out = m.bn1(out)
        out = _old_forward(m.conv2, F.relu(out), dtype)
        if m.bn2 is not None:
            out = m.bn2(out)
        return F.relu(out + x.to(dtype))
    if isinstance(m, L.MultiheadAttention):
        qkv = L._add_bias(F.linear(x.to(dtype), m.in_proj_weight.to(dtype)), m.in_proj_bias, (-1,), dtype)
        return _old_forward(m.out_proj, L.attention_core(qkv, m.num_heads).to(dtype), dtype)
    if isinstance(m, L.TransformerEncoderLayer):
        x = m.norm1(x + _old_forward(m.self_attn, x, dtype))
        ff = _old_forward(m.linear2, F.relu(_old_forward(m.linear1, x, dtype)), dtype)
        return m.norm2(x + ff)
    raise TypeError(type(m))


def _stats_(module, gen):
    """Seeded weights and BN statistics away from the identity."""
    L.init_weights_(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, L.BatchNorm2d):
                for t, lo, hi in ((m.running_mean, -0.5, 0.5), (m.running_var, 0.2, 2.0),
                                  (m.weight, 0.5, 1.5), (m.bias, -0.5, 0.5)):
                    t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)
            if isinstance(m, L.MultiheadAttention):
                m.in_proj_bias.copy_(torch.rand(m.in_proj_bias.shape, generator=gen) - 0.5)
    return module.eval()


# (layer, epilogues it runs, input shape): convs take NCHW, the rest (B, L, D)
# or, linear_4d, tokens with two batch dims (the bias over the last dim)
LAYERS = {
    "conv_bn_relu": (lambda c: L.ConvBNReLU(4, c, 3, 2, True), 1, (2, 4, 12, 12)),
    "conv_relu": (lambda c: L.ConvBNReLU(4, c, 3, 1, False), 1, (2, 4, 9, 9)),
    "resnet_block": (lambda c: L.ResnetBasicBlock(c, True), 2, (2, None, 8, 8)),
    "resnet_block_no_bn": (lambda c: L.ResnetBasicBlock(c, False), 2, (2, None, 8, 8)),
    "linear": (lambda c: L.Linear(16, c), 1, (2, 5, 16)),
    "linear_4d": (lambda c: L.Linear(16, c), 1, (2, 3, 5, 16)),
    "mha": (lambda c: L.MultiheadAttention(c, 2), 2, (2, 5, None)),
    "encoder_layer": (lambda c: L.TransformerEncoderLayer(c, 2, 24), 4, (2, 5, None)),
}


def _layer_and_input(kind, c, device, dtype, channels_last=True, seed=0):
    make, n_epi, shape = LAYERS[kind]
    gen = torch.Generator().manual_seed(seed)
    layer = _stats_(make(c), gen).to(device)
    shape = tuple(c if s is None else s for s in shape)
    x = (torch.rand(shape, generator=gen) * 4 - 2).to(device, dtype)
    if isinstance(layer, (L.ConvBNReLU, L.ResnetBasicBlock)) and channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return layer, x, n_epi


@pytest.fixture(autouse=True)
def _recording():
    """The path counters count while the recorder records."""
    profiling.enable()
    yield
    profiling.disable()


def _paths():
    c = profiling.counters()
    return c.get("epilogue.fused", 0), c.get("epilogue.plain", 0)


def _equal_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
        b.contiguous().view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_plain_path_is_the_old_chain(kind, dtype, grad):
    """On the CPU, with or without autograd, every epilogue takes the plain
    path (the counters say so) and each layer's output is bit for bit its
    forward from before the kernel."""
    layer, x, n_epi = _layer_and_input(kind, 8, "cpu", dtype)
    with torch.set_grad_enabled(grad):
        want = _old_forward(layer, x, dtype)
        before = _paths()
        got = layer(x, dtype)
    assert _paths() == (before[0], before[1] + n_epi)
    assert _equal_bits(got, want)
    assert got.requires_grad == grad


def test_wrapper_refuses_what_it_cannot_take():
    y = torch.zeros(2, 8)
    bias = torch.zeros(8, requires_grad=True)
    with torch.enable_grad(), pytest.raises(ValueError, match="requires a gradient"):
        epilogue_cuda.epilogue_cuda(y, -1, bias)
    with pytest.raises(ValueError, match="CUDA device"):
        epilogue_cuda.epilogue_cuda(y, -1, bias.detach())
    nchw = torch.zeros(2, 3, 4, 5)
    assert epilogue_cuda.rows_of_channels(nchw.contiguous(memory_format=torch.channels_last), 1)
    assert not epilogue_cuda.rows_of_channels(nchw, 1)
    assert epilogue_cuda.rows_of_channels(nchw, -1)  # tokens with two batch dims
    assert not epilogue_cuda.rows_of_channels(torch.zeros(4, 6).t(), -1)


def _epilogue_bytes(net, run, elem):
    """Bytes the epilogues of `run()` read and write, from forward hooks:
    each conv's and linear's output read as a product and written once,
    its residual read, and the attention's in-projection (3d a token)."""
    total = [0]

    def out_hook(m, args, kwargs, out):
        res = kwargs.get("residual")
        total[0] += elem * (2 * out.numel() + (0 if res is None else res.numel()))

    def mha_hook(m, args, kwargs, out):
        total[0] += elem * 2 * args[0].numel() * 3

    hooks = [m.register_forward_hook(out_hook, with_kwargs=True)
             for m in net.modules() if isinstance(m, (L.Conv2d, L.Linear))]
    hooks += [m.register_forward_hook(mha_hook, with_kwargs=True)
              for m in net.modules() if isinstance(m, L.MultiheadAttention)]
    try:
        with torch.inference_mode():
            run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def test_epilogue_roofline_counts_the_epilogues_bytes():
    """register.epilogue_roofline's bytes at the register-bop configuration
    are those that forward hooks count in one RefineNet forward on one
    pair and one ScoreNet forward on a group of two, scaled to the
    register's hypotheses (every count is linear in the pairs)."""
    from benchmark import harness

    metric = harness.load_metric("register.epilogue_roofline")
    cfg = harness.load_config("fp-estimator-bf16")
    w, res, elem = cfg["base_width"], cfg["input_res"], metric.ELEM_BYTES[cfg["compute_dtype"]]
    gen = torch.Generator().manual_seed(0)
    refine = nets.init_refine_net(nets.RefineNetCfg(base_width=w, num_heads=cfg["num_heads"]), gen)
    score = nets.init_score_net(nets.ScoreNetCfg(base_width=w, num_heads=cfg["num_heads"]), gen)
    A = torch.rand(2, res, res, 6, generator=gen)
    r_bytes = _epilogue_bytes(refine, lambda: refine(A[:1], A[1:], dtype=torch.float32), elem)
    s_bytes = _epilogue_bytes(score, lambda: score(A, A.flip(0), dtype=torch.float32), elem)
    r_out, r_res = metric.refine_elements(1, w, res, cfg["feed_forward"])
    s_out, s_res = metric.score_elements(2, w, res)
    assert r_bytes == elem * (2 * r_out + r_res)
    assert s_bytes == elem * (2 * s_out + s_res)
    n_hyp, iters = 252, cfg["register_iterations"]
    assert metric.register_bytes(cfg, n_hyp, iters) == iters * n_hyp * r_bytes + n_hyp // 2 * s_bytes


# ----------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fused_against_plain(layer, x, dtype, monkeypatch):
    """The layer's output on the fused path and on the plain ops on the
    card (the kernel turned away), with the fused path's launches."""
    with torch.inference_mode():
        want = _old_forward(layer, x, dtype)
        f0, k0 = _paths()[0], epilogue_cuda.KERNEL.launches
        got = layer(x, dtype)
        torch.cuda.synchronize()
        launched = (_paths()[0] - f0, epilogue_cuda.KERNEL.launches - k0)
        with monkeypatch.context() as mp:
            mp.setattr(epilogue_cuda, "refusal", lambda *a: "plain")
            plain = layer(x, dtype)
    return got, want, plain, launched


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,c", [
    ("conv_bn_relu", 64), ("conv_bn_relu", 3), ("conv_bn_relu", 20), ("conv_relu", 128),
    ("resnet_block", 64), ("resnet_block", 12), ("resnet_block_no_bn", 128), ("resnet_block", 512),
    ("linear", 1536), ("linear", 3), ("linear", 1), ("linear", 512), ("linear_4d", 64), ("mha", 64),
    ("encoder_layer", 64),
])
def test_fused_layers_bit_equal(card, monkeypatch, kind, c, dtype):
    """Every layer kind, channel counts that are and are not multiples of
    8 (and of 4), bf16 and f32: the fused path is bit for bit the old
    chain, with its strides, and launches one kernel per epilogue."""
    layer, x, n_epi = _layer_and_input(kind, c, card, dtype)
    got, want, plain, launched = _fused_against_plain(layer, x, dtype, monkeypatch)
    assert launched == (n_epi, n_epi)
    assert _equal_bits(got, want) and _equal_bits(plain, want)
    assert got.stride() == want.stride()


@pytest.mark.gpu
def test_contiguous_conv_input_takes_the_plain_path(card):
    """An NCHW-contiguous conv input gives an NCHW output, which the kernel
    does not take: the plain path runs, the same as before."""
    layer, x, _ = _layer_and_input("conv_bn_relu", 64, card, torch.bfloat16, channels_last=False)
    with torch.inference_mode():
        before = _paths()
        got = layer(x, torch.bfloat16)
        assert _paths() == (before[0], before[1] + 1)
        assert _equal_bits(got, _old_forward(layer, x, torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["channels_last", "tokens"])
@pytest.mark.parametrize("c", [8, 64, 13])
def test_special_values_bit_equal(card, layout, c, dtype):
    """Products and residuals holding NaN, +-inf, -0.0 and values that
    round at a bf16 tie, BN with a zero weight and zero variance: every
    flag combination fused equals the plain ops bit for bit, NaN payloads
    and the sign of zero included."""
    gen = torch.Generator().manual_seed(c)
    shape = (3, c, 5, 7) if layout == "channels_last" else (3, 35, c)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 1.0 + 2 ** -8, -3.0])

    def tensor():
        t = torch.rand(shape, generator=gen) * 8 - 4
        flat = t.view(-1)
        pick = torch.randint(0, flat.numel(), (flat.numel() // 4,), generator=gen)
        flat[pick] = specials[torch.randint(0, len(specials), (len(pick),), generator=gen)]
        t = t.to(card, dtype)
        if dtype == torch.bfloat16:  # a NaN with its sign and payload bits set
            t.view(-1).view(torch.int16)[0] = -1
        return t.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else t

    bn = L.BatchNorm2d(c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.rand(c, generator=gen) - 0.5)
        bn.running_var.copy_(torch.rand(c, generator=gen) * 2)
        bn.running_var[0] = 0.0
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.weight[-1] = 0.0
        bn.bias.copy_(torch.rand(c, generator=gen) - 0.5)
        bias = torch.rand(c, generator=gen) - 0.5
        bias[:2] = torch.tensor([-0.0, float("inf")])[: min(2, c)]
    bn, bias = bn.to(card), bias.to(card)
    y, res = tensor(), tensor()
    with torch.inference_mode():
        for flags in range(16):
            args = dict(bias=bias if flags & 1 else None, bn=bn if flags & 2 and layout == "channels_last" else None,
                        residual=res if flags & 4 else None, relu=bool(flags & 8),
                        axis=1 if layout == "channels_last" else -1)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(epilogue_cuda, "refusal", lambda *a: "plain")
                want = L.epilogue(y.clone(), dtype, **args)
            before = _paths()[0]
            got = L.epilogue(y.clone(), dtype, **args)
            assert _paths()[0] == before + 1
            assert _equal_bits(got, want), flags


def _nets(card, w=64):
    gen = torch.Generator().manual_seed(7)
    refine = _stats_(nets.RefineNet(nets.RefineNetCfg(base_width=w)), gen).to(card)
    score = _stats_(nets.ScoreNetMultiPair(nets.ScoreNetCfg(base_width=w)), gen).to(card)
    A = (torch.rand(3, 160, 160, 6, generator=gen) * 2 - 1).to(card)
    B = (torch.rand(3, 160, 160, 6, generator=gen) * 2 - 1).to(card)
    return refine, score, A, B


@pytest.mark.gpu
@pytest.mark.parametrize("replay", [False, True], ids=["eager", "captured"])
def test_whole_nets_bit_equal(card, monkeypatch, replay):
    """RefineNet and ScoreNetMultiPair at base width 64 on three pairs in
    bf16: the fused forward, eager or replayed from a captured CUDA graph,
    equals the plain ops' forward bit for bit."""
    refine, score, A, B = _nets(card)

    def forward():
        out = refine(A, B, dtype=torch.bfloat16)
        return out["trans"], out["rot"], score(A, B, dtype=torch.bfloat16)

    with torch.inference_mode():
        with monkeypatch.context() as mp:
            mp.setattr(epilogue_cuda, "refusal", lambda *a: "plain")
            want = forward()
        k0 = epilogue_cuda.KERNEL.launches
        if replay:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                forward()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static = forward()
            A.uniform_(-1, 1)  # inputs the capture did not see
            B.uniform_(-1, 1)
            with monkeypatch.context() as mp:
                mp.setattr(epilogue_cuda, "refusal", lambda *a: "plain")
                want = forward()
            graph.replay()
            got = static
        else:
            got = forward()
        torch.cuda.synchronize()
    assert epilogue_cuda.KERNEL.launches > k0
    for g, w_ in zip(got, want):
        assert _equal_bits(g, w_)
    assert np.isfinite(got[2].cpu().numpy()).all()
