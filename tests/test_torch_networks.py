"""RefineNet / ScoreNet of the port against foundationpose_tpu's networks.

JAX params -> params_from_jax -> the port's nn.Modules: f32 outputs agree
to rtol 1e-4; the state_dict names are the reference torch names (the
JAX package's converter reads them back into the identical tree); bf16
is compared layer by layer with a loose bound.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from foundationpose_tpu.models import convert as jconvert
from foundationpose_tpu.models import layers as JL
from foundationpose_tpu.models import networks as jnet
from foundationpose_torch.models import layers as TL
from foundationpose_torch.models import networks as tnet
from foundationpose_torch.models.convert import params_from_jax

RES = 32


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _nets(use_bn=True, seed=0):
    rc = jnet.RefineNetCfg(base_width=4, use_bn=use_bn)
    sc = jnet.ScoreNetCfg(base_width=4, use_bn=use_bn)
    rp = _np_tree(jnet.init_refine_net(jax.random.PRNGKey(seed), rc))
    sp = _np_tree(jnet.init_score_net(jax.random.PRNGKey(seed + 1), sc))
    if use_bn:  # non-trivial BN statistics, so the mapping is really checked
        rng = np.random.default_rng(seed)
        for tree in (rp, sp):
            for leaf_parent in _bn_dicts(tree):
                for k in ("scale", "bias", "mean"):
                    leaf_parent[k] = rng.uniform(-0.5, 0.5, leaf_parent[k].shape).astype(np.float32) + (k == "scale")
                leaf_parent["var"] = rng.uniform(0.5, 1.5, leaf_parent["var"].shape).astype(np.float32)
    tr = tnet.RefineNet(tnet.RefineNetCfg(base_width=4, use_bn=use_bn))
    tr.load_state_dict(params_from_jax(rp, tr.cfg))
    ts = tnet.ScoreNetMultiPair(tnet.ScoreNetCfg(base_width=4, use_bn=use_bn))
    ts.load_state_dict(params_from_jax(sp, ts.cfg))
    return rc, sc, rp, sp, tr.eval(), ts.eval()


def _bn_dicts(tree):
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            yield tree
        else:
            for v in tree.values():
                yield from _bn_dicts(v)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, RES, RES, 6)).astype(np.float32),
            rng.uniform(-1, 1, (n, RES, RES, 6)).astype(np.float32))


@pytest.mark.parametrize("use_bn", [True, False])
def test_f32_forward_matches_jax(use_bn):
    rc, sc, rp, sp, tr, ts = _nets(use_bn)
    A, B = _inputs(5)
    oj = jnet.apply_refine_net(rp, rc, jnp.asarray(A), jnp.asarray(B), dtype=jnp.float32)
    with torch.no_grad():
        ot = tr(torch.as_tensor(A), torch.as_tensor(B), dtype=torch.float32)
    for k in ("trans", "rot"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=1e-4, atol=1e-5)
    sj = jnet.apply_score_net(sp, sc, jnp.asarray(A), jnp.asarray(B), dtype=jnp.float32)
    with torch.no_grad():
        st = ts(torch.as_tensor(A), torch.as_tensor(B), dtype=torch.float32)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4, atol=1e-5)


def _assert_same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


def test_state_dict_names_are_the_reference_names():
    _rc, _sc, rp, sp, tr, ts = _nets()
    back_r = jconvert.convert_refine_net(
        {k: v.numpy() for k, v in tr.state_dict().items()}, use_bn=True
    )
    back_s = jconvert.convert_score_net(
        {k: v.numpy() for k, v in ts.state_dict().items()}, use_bn=True
    )
    _assert_same_tree(rp, back_r)
    _assert_same_tree(sp, back_s)
    assert "trans_head.0.self_attn.in_proj_weight" in tr.state_dict()
    assert "encodeA.0.net.1.running_var" in tr.state_dict()


def test_bf16_layer_by_layer():
    """bf16 rounds at other places in the two frameworks (bias added
    after the bf16 product here, inside the f32 accumulator in JAX), so
    each layer is compared on identical bf16 inputs against a bound of
    a few bf16 ulps of its output scale."""
    rc, _sc, rp, _sp, tr, _ts = _nets()
    bf = jnp.bfloat16
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 16, 16, 4)).astype(np.float32)

    def cmp(j, t, scale_ulps=4):
        j = np.asarray(jnp.asarray(j, jnp.float32))
        t = t.float().detach().numpy()
        bound = scale_ulps * 2.0 ** -7 * max(np.abs(j).max(), 1.0)
        assert np.abs(j - t).max() <= bound

    enc = tr.encodeA
    x_nchw = torch.as_tensor(x).permute(0, 3, 1, 2)
    # the trunk's second ConvBNReLU (stride 2, 4 -> 8 channels)
    layer_j = rp["encodeA"]["1"]
    y_j = JL.conv_bn_relu(layer_j, jnp.asarray(x), stride=2, use_bn=True, dtype=bf)
    y_t = enc[1](x_nchw, torch.bfloat16)
    cmp(y_j, y_t.permute(0, 2, 3, 1))
    res_j = JL.resnet_basic_block(rp["encodeA"]["2"], y_j, use_bn=True, dtype=bf)
    res_t = enc[2](torch.as_tensor(np.asarray(y_j.astype(jnp.float32))).permute(0, 3, 1, 2), torch.bfloat16)
    cmp(res_j, res_t.permute(0, 2, 3, 1))
    tok = rng.uniform(-1, 1, (2, 12, rc.embed_dim)).astype(np.float32)
    lj = JL.transformer_encoder_layer(rp["trans_head"]["0"], jnp.asarray(tok, bf), rc.num_heads, dtype=bf)
    lt = tr.trans_head[0](torch.as_tensor(tok).to(torch.bfloat16), torch.bfloat16)
    cmp(lj, lt, scale_ulps=8)
    # whole net in bf16: same outputs to a loose bound
    A, B = _inputs(3, seed=1)
    oj = jnet.apply_refine_net(rp, rc, jnp.asarray(A), jnp.asarray(B), dtype=bf)
    with torch.no_grad():
        ot = tr(torch.as_tensor(A), torch.as_tensor(B), dtype=torch.bfloat16)
    for k in ("trans", "rot"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=5e-2, rtol=0)


def test_positional_embedding_and_init():
    np.testing.assert_allclose(
        TL.positional_embedding(32, 400).numpy(),
        np.asarray(JL.positional_embedding(32, 400)), atol=1e-6,
    )
    a = tnet.init_refine_net(tnet.RefineNetCfg(base_width=4), torch.Generator().manual_seed(0))
    b = tnet.init_refine_net(tnet.RefineNetCfg(base_width=4), torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.encodeA[0].net[0].weight
    bound = (1.0 / (6 * 7 * 7)) ** 0.5 * 3**0.5
    assert w.abs().max() <= bound and w.std() > bound / 3
