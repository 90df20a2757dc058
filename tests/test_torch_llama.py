"""The port's Llama model (``mxnet_tpu_torch.gluon.model_zoo.llama``)
against the JAX package's, on the CPU: the cases of ``test_llama.py``
except the sequence-parallel ones (not ported).  Weights are made by the
JAX package from its seed and carried across with ``load_jax_params``;
tokens come from numpy seeds.  Logits agree to 1e-4 in f32.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo import llama as jllama
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import llama as tllama


def _jax_net(seed, build=jllama.llama_small, **kw):
    mx.random.seed(seed)
    net = build(**kw)
    net.initialize(mx.init.Xavier())
    return net


def _jax_params(net, tokens):
    net(nd.array(tokens))       # resolves deferred shapes
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _port_twin(jnet, tokens, build=tllama.llama_small, **kw):
    params = _jax_params(jnet, tokens)
    net = build(device="cpu", **kw)
    tllama.load_jax_params(net, params)
    return net


def _logits(net, tokens):
    with torch.no_grad():
        return net(torch.from_numpy(tokens)).numpy()


def test_forward_matches_jax_and_hybridize_is_a_noop():
    """``hybridize()`` arms the block (a captured CUDA graph per input
    signature on the card); on the CPU it changes no number: calls 1, 2
    and 3 give the eager logits (tests/test_torch_graphs.py holds the
    rules)."""
    toks = np.random.RandomState(0).randint(0, 512, (2, 16)) \
        .astype(np.float32)
    jnet = _jax_net(0)
    want = jnet(nd.array(toks)).asnumpy()
    net = _port_twin(jnet, toks)
    got = _logits(net, toks)
    assert got.shape == (2, 16, 512)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert net.hybridize() is net and net._active
    for _ in range(3):
        np.testing.assert_array_equal(_logits(net, toks), got)
    (cc,) = net._graphs.calls.values()
    assert (cc.calls, cc.captures) == (3, 0)


def test_state_dict_keys_are_the_jax_structural_names():
    toks = np.zeros((1, 4), np.float32)
    jnet = _jax_net(1)
    names = list(_jax_params(jnet, toks))
    net = tllama.llama_small(device="cpu")
    assert sorted(net.state_dict()) == sorted(names)
    assert sorted(net._collect_params_with_prefix()) == sorted(names)
    assert "blocks.1.ffn.down.weight" in names and "lm_head.weight" in names


def test_load_jax_params_is_strict_and_names_the_key():
    toks = np.zeros((1, 4), np.float32)
    params = _jax_params(_jax_net(2), toks)
    net = tllama.llama_small(device="cpu")
    with pytest.raises(MXNetError, match="norm.weight"):
        tllama.load_jax_params(net, {k: v for k, v in params.items()
                                     if k != "norm.weight"})
    with pytest.raises(MXNetError, match="extra.weight"):
        tllama.load_jax_params(net, dict(params, **{
            "extra.weight": np.zeros(2, np.float32)}))
    bad = dict(params)
    bad["embed.weight"] = bad["embed.weight"][:, :8]
    with pytest.raises(MXNetError, match="embed.weight"):
        tllama.load_jax_params(net, bad)


def test_causality():
    """Changing a future token must not affect earlier logits."""
    rs = np.random.RandomState(1)
    toks = rs.randint(0, 512, (1, 12)).astype(np.float32)
    net = _port_twin(_jax_net(1), toks)
    out1 = _logits(net, toks)
    toks2 = toks.copy()
    toks2[0, -1] = (toks2[0, -1] + 7) % 512
    out2 = _logits(net, toks2)
    np.testing.assert_allclose(out1[:, :-1], out2[:, :-1], atol=1e-5)
    assert np.abs(out1[:, -1] - out2[:, -1]).max() > 1e-4


def test_rope_preserves_norm_and_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(1, 2, 8, 16).astype(np.float32)
    got = tllama._rope(torch.from_numpy(x), 500000.0).numpy()
    want = jllama._rope(nd, nd.array(x), 500000.0).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def norms(a):
        half = a.shape[-1] // 2
        return np.sqrt(a[..., :half] ** 2 + a[..., half:] ** 2)

    np.testing.assert_allclose(norms(got), norms(x), atol=1e-5)
    np.testing.assert_allclose(got[:, :, 0], x[:, :, 0], atol=1e-6)
    # the relative phase: <rope(q)_i, rope(k)_j> depends on i - j only
    q = np.tile(rs.randn(1, 1, 1, 16).astype(np.float32), (1, 1, 8, 1))
    rq = tllama._rope(torch.from_numpy(q)).numpy()[0, 0]
    dots = [float(rq[i] @ rq[i + 2]) for i in range(6)]
    np.testing.assert_allclose(dots, dots[0], rtol=1e-4)


def test_gqa_matches_mha_when_kv_repeated():
    """With fewer KV heads, repeating each KV head's projection rows in
    place (jnp.repeat / repeat_interleave, not tiling) must reproduce
    the output of the MHA model."""
    toks = np.random.RandomState(3).randint(0, 64, (1, 8)) \
        .astype(np.float32)
    cfg = dict(units=32, hidden_size=64, num_layers=1, num_heads=4)
    jgqa = _jax_net(3, jllama.LlamaModel, vocab_size=64, num_kv_heads=2,
                    **cfg)
    gqa = _port_twin(jgqa, toks, tllama.LlamaModel, vocab_size=64,
                     num_kv_heads=2, **cfg)
    mha = tllama.LlamaModel(64, num_kv_heads=4, device="cpu", **cfg)
    d = 8
    state = {}
    for name, w in gqa.state_dict().items():
        if "attn.k_proj" in name or "attn.v_proj" in name:
            heads = w.reshape(2, d, -1)
            w = torch.cat([heads[0], heads[0], heads[1], heads[1]])
        state[name] = w
    mha.load_state_dict(state)
    np.testing.assert_allclose(_logits(gqa, toks), _logits(mha, toks),
                               atol=1e-4)
    np.testing.assert_allclose(_logits(gqa, toks),
                               jgqa(nd.array(toks)).asnumpy(), rtol=1e-4,
                               atol=1e-4)


def test_tied_embeddings():
    toks = np.random.RandomState(4).randint(0, 512, (2, 8)) \
        .astype(np.float32)
    jnet = _jax_net(4, tie_embeddings=True)
    want = jnet(nd.array(toks)).asnumpy()
    net = _port_twin(jnet, toks, tie_embeddings=True)
    assert not any("head" in k for k in net.state_dict())
    np.testing.assert_allclose(_logits(net, toks), want, rtol=1e-4,
                               atol=1e-4)


def test_cast_to_bf16_keeps_names_and_runs():
    toks = np.random.RandomState(5).randint(0, 512, (1, 8)) \
        .astype(np.float32)
    jnet = _jax_net(5)
    want = jnet(nd.array(toks)).asnumpy()
    net = _port_twin(jnet, toks).cast("bfloat16")
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    with torch.no_grad():
        out = net(torch.from_numpy(toks))
    assert out.dtype == torch.bfloat16
    # bf16 weights and activations: within a few bf16 ulps of f32
    np.testing.assert_allclose(out.float().numpy(), want, atol=0.1)
