"""The port's BERT path against the JAX package's, on the CPU: the norm
ops and layers (``LayerNorm``, ``GroupNorm``, ``InstanceNorm``),
``Dense(activation=)``, the containers (``Concurrent``,
``HybridConcurrent``, ``Lambda``, ``HybridLambda``), ``bert_small``'s
forward, gradients (the tied ``word_embed.weight`` included), adam
``JitTrainStep`` steps and ``hybridize()``, its dtypes under AMP,
``bert_base``'s geometry, and ``JitTrainStep.save_states`` files
crossing between the packages.

Inputs and weights come from numpy seeds and the JAX package's
initializer, carried across with ``bert.load_jax_params``; the JAX
side's gradients come from its imperative autograd.

Tolerances: f32 layers and ops rtol 1e-4 / atol 1e-5; ``bert_small``
outputs and gradients within 1e-4 of each tensor's largest magnitude;
losses 1e-5; weights after adam steps 1e-4 (adam divides by sqrt(v));
bf16 under AMP within 2 bf16 ulps (2^-7) of a layer's largest value and
within 2^-5 of ``bert_small``'s largest output.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd, nd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import gluon, initializer, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import bert, vision

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LAYER = 2 ** -7
BF16_NET = 2 ** -5


def _close(got, want, rel=1e-4, what=""):
    """Equal within ``rel`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, "%s: error %.3g of the largest value (%.3g) > %.3g" \
        % (what, err, scale, rel)


def _np(t):
    """A port tensor (or a JAX NDArray) as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.asnumpy(), np.float32)


def _params(jblock):
    return {k: p.data().asnumpy()
            for k, p in jblock._collect_params_with_prefix().items()}


# ---------------------------------------------------------------------------
# the norm ops and layers


def _jax_run(layer, x, head):
    xj = nd.array(x)
    xj.attach_grad()
    with autograd.record():
        out = layer(xj)
    out.backward(nd.array(head))
    grads = {k: p.grad().asnumpy()
             for k, p in layer._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xj.grad.asnumpy(), grads


def _port_run(layer, x, head):
    xt = torch.from_numpy(x).requires_grad_()
    with tautograd.record():
        out = layer(xt)
    out.backward(torch.from_numpy(head))
    grads = {k: t.grad.numpy() for k, t in layer._collect_params_with_prefix().items()
             if t.requires_grad}
    return out.detach().numpy(), xt.grad.numpy(), grads


def _check_layer(jlayer, layer, x, seed=1):
    """``jlayer`` (initialized) and ``layer`` with its parameters on
    ``x``: outputs and the gradients of the input and every parameter
    that takes one."""
    head = np.random.RandomState(seed).standard_normal(
        jlayer(nd.array(x)).shape).astype(np.float32)
    params = _params(jlayer)
    want, want_dx, want_g = _jax_run(jlayer, x, head)
    if params:
        vision.load_jax_params(layer, params)
    got, got_dx, got_g = _port_run(layer, x, head)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_dx, want_dx, **TOL)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **TOL)


NORM_CASES = [
    ("LayerNorm", dict(), (2, 5, 8)),
    ("LayerNorm", dict(axis=1, epsilon=1e-3), (2, 6, 4)),
    ("LayerNorm", dict(center=False, scale=False), (3, 7)),
    ("LayerNorm", dict(in_channels=8), (2, 3, 8)),
    ("GroupNorm", dict(num_groups=2), (2, 6, 5, 3)),
    ("GroupNorm", dict(num_groups=3, center=False), (2, 6, 7)),
    ("InstanceNorm", dict(), (2, 3, 5, 4)),
    ("InstanceNorm", dict(scale=True, epsilon=1e-3), (3, 4, 9)),
]


@pytest.mark.parametrize("cls,kw,shape", NORM_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(NORM_CASES)])
def test_norm_layer_matches_jax(cls, kw, shape):
    """Output and the gradients of the input and of gamma/beta where
    ``scale``/``center`` leave them on; a deferred shape is taken from
    the first input."""
    mx.random.seed(3)
    jlayer = getattr(jnn, cls)(**kw)
    jlayer.initialize(mx.init.Xavier())
    rs = np.random.RandomState(0)
    x = (rs.standard_normal(shape) * 3 + 1).astype(np.float32)
    jlayer(nd.array(x))
    # non-trivial gamma and beta
    for name in ("gamma", "beta"):
        p = getattr(jlayer, name)
        p.set_data(nd.array(rs.uniform(0.5, 1.5, p.shape).astype(np.float32)))
    layer = getattr(nn, cls)(device="cpu", **kw)
    layer.initialize()
    _check_layer(jlayer, layer, x)
    for name, grad in (("gamma", kw.get("scale", cls != "InstanceNorm")),
                       ("beta", kw.get("center", True))):
        assert getattr(layer, name).requires_grad == grad, name


@pytest.mark.parametrize("op,attrs,shape", [
    ("LayerNorm", dict(axis=-1, eps=1e-5), (2, 3, 8)),
    ("LayerNorm", dict(axis=0, eps=1e-2), (4, 3)),
    ("GroupNorm", dict(num_groups=2, eps=1e-5), (2, 4, 3, 3)),
    ("InstanceNorm", dict(eps=1e-3), (2, 3, 6)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_ops_match_jax(op, attrs, shape, dtype):
    """The registered ops through ``mx.nd`` (aliases included): f32
    within the layer tolerance, bf16 in and out (statistics and affine
    in f32, one rounding) within 2 bf16 ulps of the largest value."""
    rs = np.random.RandomState(4)
    x = (rs.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    c = shape[attrs.get("axis", 1)] if op == "LayerNorm" else shape[1]
    g = rs.uniform(0.5, 1.5, c).astype(np.float32)
    b = rs.standard_normal(c).astype(np.float32)
    want = getattr(nd, op)(nd.array(x, dtype=dtype), nd.array(g),
                           nd.array(b), **attrs)
    alias = {"LayerNorm": "layer_norm", "GroupNorm": "group_norm",
             "InstanceNorm": "instance_norm"}[op]
    with tmx.cpu():
        got = [getattr(tmx.nd, name)(tmx.nd.array(x).astype(dtype),
                                     tmx.nd.array(g), tmx.nd.array(b),
                                     **attrs) for name in (op, alias)]
    for out in got:
        assert str(out.dtype).endswith(dtype)
        if dtype == "float32":
            np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), **TOL)
        else:
            _close(out.asnumpy(), _np(want), BF16_LAYER, op)


@pytest.mark.parametrize("cls,kw,shape", [
    ("LayerNorm", dict(), (2, 4, 16)),
    ("GroupNorm", dict(num_groups=4), (2, 8, 6)),
    ("InstanceNorm", dict(scale=True), (2, 4, 10)),
])
def test_norm_layers_under_amp_return_f32(cls, kw, shape):
    """Under AMP the norms are on the f32 list: a bf16 input (and bf16
    parameters after ``convert_hybrid_block``) gives an f32 output, as
    the JAX package's; values within 2 bf16 ulps of the largest."""
    mx.random.seed(5)
    jlayer = getattr(jnn, cls)(**kw)
    jlayer.initialize(mx.init.Xavier())
    rs = np.random.RandomState(5)
    x = (rs.standard_normal(shape) * 2).astype(np.float32)
    jlayer(nd.array(x))
    layer = getattr(nn, cls)(device="cpu", **kw)
    layer.initialize()
    vision.load_jax_params(layer, _params(jlayer))
    try:
        jamp.init("bfloat16")
        jamp.convert_hybrid_block(jlayer)
        tamp.init("bfloat16")
        tamp.convert_hybrid_block(layer)
        want = jlayer(nd.array(x, dtype="bfloat16"))
        got = layer(torch.from_numpy(x).to(torch.bfloat16))
    finally:
        jamp.turn_off()
        tamp.turn_off()
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    assert layer.gamma.dtype == torch.bfloat16
    _close(_np(got), _np(want), BF16_LAYER, cls)


def test_lazy_norm_and_dense_take_the_dtype_of_a_cast_before_the_fill():
    """``in_channels=0`` / ``in_units=0`` cast to bf16 before the first
    forward: the parameters are made bf16 at that forward and hold the
    values of twins filled in f32 and cast after (one rounding of the
    same draw, as the JAX package's deferred init)."""
    def net(cast_first):
        block = nn.HybridSequential()
        block.add(nn.Dense(6, flatten=False, device="cpu"),
                  nn.LayerNorm(device="cpu"))
        block.initialize(initializer.Xavier(),
                         generator=torch.Generator().manual_seed(7))
        x = torch.ones(2, 5)
        if cast_first:
            block.cast("bfloat16")
            block(x.to(torch.bfloat16))
        else:
            block(x)
            block.cast("bfloat16")
        return block

    early, late = net(True), net(False)
    for (name, a), b in zip(early._collect_params_with_prefix().items(),
                            late._collect_params_with_prefix().values()):
        assert a.dtype == torch.bfloat16, name
        assert torch.equal(a, b), name
    assert early[0].weight.std() > 0


# ---------------------------------------------------------------------------
# Dense(activation=) and the containers


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "gelu", "silu", "erf"])
def test_dense_activation_matches_jax(act):
    mx.random.seed(6)
    jlayer = jnn.Dense(5, activation=act, in_units=4)
    jlayer.initialize(mx.init.Xavier())
    layer = nn.Dense(5, activation=act, in_units=4, device="cpu")
    x = np.random.RandomState(6).standard_normal((3, 4)).astype(np.float32)
    _check_layer(jlayer, layer, x)
    assert repr(layer) == repr(jlayer) == \
        "Dense(4 -> 5, Activation(%s))" % act
    assert repr(nn.Dense(3, in_units=2, device="cpu")) == \
        repr(jnn.Dense(3, in_units=2)) == "Dense(2 -> 3, linear)"


@pytest.mark.parametrize("hybrid", [False, True])
def test_concurrent_matches_jax(hybrid):
    """Children on one input, concatenated along ``axis``: outputs and
    gradients."""
    mx.random.seed(7)
    jcls = jnn.HybridConcurrent if hybrid else jnn.Concurrent
    cls = nn.HybridConcurrent if hybrid else nn.Concurrent
    jblock, block = jcls(axis=1), cls(axis=1)
    for units in (3, 4):
        jblock.add(jnn.Dense(units, in_units=5))
        block.add(nn.Dense(units, in_units=5, device="cpu"))
    jblock.add(jnn.Activation("tanh"))
    block.add(nn.Activation("tanh"))
    jblock.initialize(mx.init.Xavier())
    x = np.random.RandomState(7).standard_normal((2, 5)).astype(np.float32)
    _check_layer(jblock, block, x)
    if hybrid:
        block.hybridize()
        with torch.no_grad():
            np.testing.assert_allclose(block(torch.from_numpy(x)).numpy(),
                                       jblock(nd.array(x)).asnumpy(), **TOL)


@pytest.mark.parametrize("case", ["name", "function"])
def test_lambda_and_hybrid_lambda_match_jax(case):
    """``Lambda`` on a registered op's name or a function of tensors;
    ``HybridLambda`` on a name or ``function(F, x)`` with ``F.<op>`` the
    registered ops."""
    x = np.random.RandomState(8).standard_normal((3, 4)).astype(np.float32)
    if case == "name":
        pairs = [(jnn.Lambda("tanh"), nn.Lambda("tanh")),
                 (jnn.HybridLambda("relu"), nn.HybridLambda("relu"))]
    else:
        pairs = [(jnn.Lambda(lambda a: nd.sigmoid(a) * 2),
                  nn.Lambda(lambda a: torch.sigmoid(a) * 2)),
                 (jnn.HybridLambda(lambda F, a: F.tanh(a) + F.relu(a)),
                  nn.HybridLambda(lambda F, a: F.tanh(a) + F.relu(a)))]
    for jblock, block in pairs:
        _check_layer(jblock, block, x)
        assert repr(block) == repr(jblock)
    with pytest.raises(MXNetError, match="not found"):
        nn.Lambda("no_such_op")
    with pytest.raises(MXNetError, match="str or callable"):
        nn.HybridLambda(3)


# ---------------------------------------------------------------------------
# BERT


def _twins(seed, toks, types=None, vocab=50, **kw):
    """A JAX bert_small from ``seed`` (one forward makes its deferred
    shapes) and the port's copy of it."""
    mx.random.seed(seed)
    jnet = jbert.bert_small(vocab_size=vocab, **kw)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(toks), None if types is None else nd.array(types))
    net = bert.bert_small(vocab_size=vocab, device="cpu", **kw)
    bert.load_jax_params(net, _params(jnet))
    return jnet, net


def _batch(seed, vocab=50, shape=(2, 16)):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, shape).astype(np.int32),
            rs.randint(0, 2, shape).astype(np.int32),
            rs.randint(0, vocab, shape).astype(np.float32))


@pytest.mark.parametrize("with_types", [False, True])
def test_bert_small_forward_matches_jax(with_types):
    """``(seq, pooled, logits)`` in f32, with and without token types,
    within 1e-4 of each output's largest magnitude."""
    toks, types, _ = _batch(0)
    types = types if with_types else None
    jnet, net = _twins(0, toks, types)
    want = jnet(nd.array(toks), None if types is None else nd.array(types))
    got = net(torch.from_numpy(toks),
              None if types is None else torch.from_numpy(types))
    for name, g, w in zip(("seq", "pooled", "logits"), got, want):
        assert g.dtype == torch.float32
        _close(_np(g), _np(w), 1e-4, name)


def test_causal_attention_is_causal():
    """The JAX package's test on the port's cell (weights carried): with
    ``causal=True`` the output at position i ignores positions > i, and
    both outputs equal the JAX package's."""
    mx.random.seed(2)
    jcell = jbert.MultiHeadAttention(32, 4, causal=True)
    jcell.initialize(mx.init.Xavier())
    rs = np.random.RandomState(3)
    x = rs.randn(1, 8, 32).astype(np.float32)
    jbase = jcell(nd.array(x)).asnumpy()
    cell = bert.MultiHeadAttention(32, 4, causal=True, device="cpu")
    vision.load_jax_params(cell, _params(jcell))
    with torch.no_grad():
        base = cell(torch.from_numpy(x)).numpy()
        x2 = x.copy()
        x2[0, -1] += 10.0   # perturb the LAST position only
        out2 = cell(torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(out2[0, :-1], base[0, :-1], rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(out2[0, -1], base[0, -1])
    np.testing.assert_allclose(base, jbase, **TOL)
    np.testing.assert_allclose(out2, jcell(nd.array(x2)).asnumpy(), **TOL)


def _mlm_loss_jax(jnet, toks, types, labels, vocab):
    with autograd.record():
        _, _, lg = jnet(nd.array(toks), nd.array(types))
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            nd.reshape(lg, shape=(-1, vocab)),
            nd.reshape(nd.array(labels), shape=(-1,))).mean()
    loss.backward()
    return loss


def _mlm_loss_port(net, toks, types, labels, vocab):
    with tautograd.record():
        _, _, lg = net(torch.from_numpy(toks), torch.from_numpy(types))
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            lg.reshape(-1, vocab), torch.from_numpy(labels).reshape(-1)) \
            .mean()
    loss.backward()
    return loss


def test_mlm_gradients_match_jax_and_write_mode_overwrites():
    """Every parameter's gradient of the MLM loss against the JAX
    package's autograd, the tied ``word_embed.weight`` (the embedding's
    and the head's contributions summed in one backward) included,
    within 1e-4 of each gradient's largest magnitude.  A second backward
    overwrites the gradients (``grad_req="write"``), as in the JAX
    package, and ``Trainer.step`` leaves them readable."""
    toks, types, labels = _batch(1)
    jnet, net = _twins(1, toks, types)
    jl = _mlm_loss_jax(jnet, toks, types, labels, 50)
    loss = _mlm_loss_port(net, toks, types, labels, 50)
    np.testing.assert_allclose(loss.item(), jl.asscalar(), rtol=1e-5)
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    # the pooler is not on the loss's path: the JAX package's gradient
    # stays zeros, the port's None
    unused = [k for k, p in net.named_parameters() if p.grad is None]
    assert unused == ["pooler.weight", "pooler.bias"]
    assert all(not jgrads[k].any() for k in unused)
    grads = {k: p.grad.clone() for k, p in net.named_parameters()
             if k not in unused}
    assert sorted(grads) == sorted(set(jgrads) - set(unused))
    for k in grads:
        _close(grads[k].numpy(), jgrads[k], 1e-4, k)
    # the head alone must not give the tied weight's gradient
    head_only = jgrads["word_embed.weight"] - grads[
        "word_embed.weight"].numpy()
    assert np.abs(head_only).max() < 1e-4 * np.abs(jgrads[
        "word_embed.weight"]).max()
    _mlm_loss_jax(jnet, toks, types, labels, 50)
    _mlm_loss_port(net, toks, types, labels, 50)
    jw = jnet._collect_params_with_prefix()["word_embed.weight"]
    _close(jw.grad().asnumpy(), jgrads["word_embed.weight"], 1e-6,
           "JAX, second backward")
    for k in grads:
        assert torch.equal(net.get_parameter(k).grad, grads[k]), k
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.0})
    trainer.step(1, ignore_stale_grad=True)     # the pooler: no gradient
    assert torch.equal(net.word_embed.weight.grad,
                       grads["word_embed.weight"])


def _jax_mlm(inner, vocab):
    class MLM(jgluon.HybridBlock):
        def __init__(self, net):
            super().__init__()
            self.inner = net

        def hybrid_forward(self, F, toks):
            _, _, logits = self.inner(toks)
            return F.reshape(logits, shape=(-1, vocab))

    return MLM(inner)


def _port_mlm(inner, vocab):
    class MLM(gluon.HybridBlock):
        def __init__(self, net):
            super().__init__()
            self.inner = net

        def forward(self, toks):
            return self.inner(toks)[2].reshape(-1, vocab)

    return MLM(inner)


def _steps(jnet, net, vocab=40, lr=3e-3):
    jstep = jparallel.JitTrainStep(
        _jax_mlm(jnet, vocab), jgluon.loss.SoftmaxCrossEntropyLoss(),
        "adam", {"learning_rate": lr})
    step = parallel.JitTrainStep(
        _port_mlm(net, vocab), gluon.loss.SoftmaxCrossEntropyLoss(),
        "adam", {"learning_rate": lr})
    return jstep, step


def test_jit_train_step_adam_matches_jax():
    """3 adam steps of the MLM wrapper from the same weights and batch
    (``bench.py``'s BERT workload at bert_small): losses within 1e-5,
    weights within 1e-4, and the loss falls.  The key projection's bias
    is held apart: softmax ignores a shift of a row's scores, so its
    gradient is 0 in exact arithmetic and each package's adam
    normalizes its own rounding noise (a step of up to ``lr``); it must
    stay within 3 ``lr`` of the JAX package's."""
    rs = np.random.RandomState(2)
    toks = rs.randint(0, 40, (2, 8)).astype(np.int32)
    labels = rs.randint(0, 40, 16).astype(np.float32)
    jnet, net = _twins(2, toks, vocab=40)
    jstep, step = _steps(jnet, net)
    losses = []
    for _ in range(3):
        want = float(jstep.step(toks, labels))
        got = step.step(toks, labels)
        np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-5)
        losses.append(got.item())
    assert losses[-1] < losses[0]
    jstep.sync_params()
    jparams = jnet._collect_params_with_prefix()
    for name, p in net.named_parameters():
        got, want = p.detach().numpy(), jparams[name].data().asnumpy()
        if name.endswith("attn.qkv.bias"):
            key = slice(64, 128)
            np.testing.assert_allclose(got[key], want[key], atol=3 * 3e-3,
                                       err_msg=name)
            got, want = np.delete(got, key), np.delete(want, key)
        np.testing.assert_allclose(got, want, err_msg=name, rtol=1e-4,
                                   atol=1e-4)


def test_jit_train_step_save_states_cross_both_ways(tmp_path):
    """A file the JAX package's ``JitTrainStep.save_states`` writes after
    2 adam steps loads into the port's step (weights, adam state and the
    count), and the next step's loss agrees; then the port's file after
    that step loads into a fresh JAX step, whose next loss agrees with
    the port's."""
    rs = np.random.RandomState(3)
    toks = rs.randint(0, 40, (2, 8)).astype(np.int32)
    labels = rs.randint(0, 40, 16).astype(np.float32)
    jnet, net = _twins(3, toks, vocab=40)
    jstep, step = _steps(jnet, net)
    for _ in range(2):
        jstep.step(toks, labels)
    jfile = str(tmp_path / "jax.mxgc")
    jstep.save_states(jfile)
    step.step(toks, labels)                 # placement, then overwritten
    step.load_states(jfile)
    assert step._t == 2 and int(step._count) == 2
    for i, (p, w) in enumerate(zip(step._params, jstep._weights)):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(w),
                                      err_msg=step._names[i])
    for st, jst in zip(step._opt_state, jstep._opt_state):
        for a, b in zip(st, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = float(jstep.step(toks, labels))
    got = step.step(toks, labels).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    pfile = str(tmp_path / "port.mxgc")
    step.save_states(pfile)
    mx.random.seed(9)
    jnet2 = jbert.bert_small(vocab_size=40)
    jnet2.initialize(mx.init.Xavier())
    jstep2 = jparallel.JitTrainStep(
        _jax_mlm(jnet2, 40), jgluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 3e-3})
    jstep2.step(toks, labels)               # placement, then overwritten
    jstep2.load_states(pfile)
    assert jstep2._t == 3
    for p, w in zip(step._params, jstep2._weights):
        np.testing.assert_array_equal(np.asarray(w), p.detach().numpy())
    np.testing.assert_allclose(float(jstep2.step(toks, labels)),
                               step.step(toks, labels).item(), rtol=1e-5)
    fresh = parallel.JitTrainStep(_port_mlm(net, 40), None, "adam")
    with pytest.raises(MXNetError, match="run one step"):
        fresh.load_states(pfile)
    bad = tmp_path / "bad"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(MXNetError, match="not an MXGC1"):
        step.load_states(str(bad))


def test_hybridized_bert_matches_eager_and_its_graph_pair_trains():
    """``hybridize()``: the logits equal the eager net's; 3 Trainer adam
    steps under ``record()`` through the graph pair's host double (eager
    runs in place of the replays) give the eager net's losses and
    weights bitwise, the tied weight's two contributions summed, and two
    backward passes of the pair give one backward's gradient."""
    toks, types, labels = _batch(4)
    _, eager = _twins(4, toks, types)
    _, paired = _twins(4, toks, types)
    paired.hybridize()
    with torch.no_grad():
        for a, b in zip(eager(torch.from_numpy(toks), torch.from_numpy(types)),
                        paired(torch.from_numpy(toks),
                               torch.from_numpy(types))):
            assert torch.equal(a, b)
    paired._graphs.pairs_on = lambda device: True

    def train(net):
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
        losses = []
        for _ in range(3):
            losses.append(_mlm_loss_port(net, toks, types, labels,
                                         50).item())
            trainer.step(1, ignore_stale_grad=True)
        return losses

    assert train(paired) == train(eager)
    for (name, a), b in zip(paired.named_parameters(), eager.parameters()):
        assert torch.equal(a, b), name
    pair = [c for k, c in paired._graphs.calls.items() if len(k) == 4]
    assert len(pair) == 1 and pair[0].backward_replays == 2
    _mlm_loss_port(paired, toks, types, labels, 50)
    once = paired.word_embed.weight.grad.clone()
    _mlm_loss_port(paired, toks, types, labels, 50)
    assert torch.equal(paired.word_embed.weight.grad, once)


def test_amp_bf16_dtypes_match_jax():
    """Under ``amp.init("bfloat16")`` and ``convert_hybrid_block`` (cast
    before the first forward, as ``bench.py`` does): every parameter is
    bf16, ``seq`` is f32 (LayerNorm is on the f32 list), ``pooled`` and
    ``logits`` are bf16 and the loss f32, as in the JAX package; values
    within 2^-5 of each output's largest magnitude."""
    toks, types, labels = _batch(5)
    mx.random.seed(5)
    jnet = jbert.bert_small(vocab_size=50)
    jnet.initialize(mx.init.Xavier())
    net = bert.bert_small(vocab_size=50, device="cpu")
    try:
        jamp.init("bfloat16")
        jamp.convert_hybrid_block(jnet)
        want = jnet(nd.array(toks), nd.array(types))
        bert.load_jax_params(net, _params(jnet))
        tamp.init("bfloat16")
        tamp.convert_hybrid_block(net)
        got = net(torch.from_numpy(toks), torch.from_numpy(types))
        jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            nd.reshape(want[2], shape=(-1, 50)),
            nd.array(labels.reshape(-1)))
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            got[2].reshape(-1, 50), torch.from_numpy(labels).reshape(-1))
    finally:
        jamp.turn_off()
        tamp.turn_off()
    jdtypes = {str(p.data().dtype)
               for p in jnet._collect_params_with_prefix().values()}
    assert jdtypes == {"bfloat16"}
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    for name, g, w in zip(("seq", "pooled", "logits", "loss"),
                          got + (loss,), want + (jloss,)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), name
        _close(_np(g), _np(w), BF16_NET, name)


def test_bert_base_geometry_matches_jax():
    """``bert_base``'s parameter names and shapes equal the JAX
    package's (one layer, vocab 1000, after its forward), and the full
    model has the JAX package's parameter count at vocab 30,522:
    109,512,762."""
    mx.random.seed(0)
    jnet = jbert.bert_base(vocab_size=1000, num_layers=1)
    jnet.initialize(mx.init.Xavier())
    toks, types, _ = _batch(0, vocab=1000, shape=(1, 8))
    jnet(nd.array(toks), nd.array(types))
    want = {k: v.shape for k, v in _params(jnet).items()}
    net = bert.bert_base(vocab_size=1000, num_layers=1, device="cpu")
    assert {k: tuple(p.shape) for k, p in net.named_parameters()} == want
    assert list(dict(net.named_parameters())) == list(want)
    full = bert.bert_base(device="cpu")
    assert len(full.encoder.layers) == 12
    n = sum(p.numel() for p in full.parameters())
    per_layer = sum(int(np.prod(s)) for k, s in want.items()
                    if k.startswith("encoder.layers.0."))
    rest = sum(int(np.prod(s)) for k, s in want.items()
               if not k.startswith("encoder."))
    assert n == 12 * per_layer + rest + 29522 * (768 + 1) == 109512762


def test_load_jax_params_is_strict():
    toks, _, _ = _batch(6)
    jnet, net = _twins(6, toks)
    params = _params(jnet)
    for broken, what in (
            ({k: v for k, v in params.items() if k != "mlm_bias"},
             "missing.*mlm_bias"),
            (dict(params, extra=np.zeros(3, np.float32)),
             "unexpected.*extra"),
            (dict(params, pos_embed=np.zeros((4, 64), np.float32)),
             "pos_embed has shape")):
        with pytest.raises(MXNetError, match=what):
            bert.load_jax_params(net, broken)
