"""The ops of the port's ``ops/nn.py`` that came with the op tail
(``FullyConnected``, ``Embedding``, ``L2Normalization``, ``RMSNorm``,
``softmin``, ``SoftmaxActivation``, ``SoftmaxOutput``, ``smooth_l1``,
``softmax_cross_entropy``, the ``_contrib_*`` attention helpers,
``UpSampling`` and ``BilinearSampler``) against the JAX package's, on
the CPU: the same seeded numpy inputs through both, forward and
gradients.  The JAX side's gradients are ``jax.vjp`` of its op's
forward with the same seeded head.  ``Deconvolution`` has a file of its
own (``test_torch_deconv.py``).

Tolerances (f32): rtol 1e-5 / atol 1e-6 for forwards, rtol 1e-4 /
atol 1e-5 for gradients (XLA and torch sum in different orders); the
gathers and masks are bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _jax_vjp(name, inputs, attrs, diff, head_seed=7):
    """The JAX op's outputs and, for the inputs at ``diff``, the vjp of
    its first output against a seeded head."""
    fwd = jreg.get(name).forward
    args = [jnp.asarray(x) for x in inputs]

    def f(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        out = fwd(*full, **attrs)
        return out[0] if isinstance(out, tuple) else out

    out, vjp = jax.vjp(f, *[args[i] for i in diff])
    head = np.random.RandomState(head_seed).standard_normal(
        out.shape).astype(np.asarray(out).dtype)
    grads = vjp(jnp.asarray(head)) if diff else ()
    return np.asarray(out), head, [np.asarray(g) for g in grads]


def _port_vjp(name, inputs, attrs, diff, head):
    ts = [torch.from_numpy(np.array(x)) for x in inputs]
    for i in diff:
        ts[i].requires_grad_()
    out = treg.get(name).forward(*ts, **attrs)
    out = out[0] if isinstance(out, tuple) else out
    if diff:
        out.backward(torch.from_numpy(head))
    return out.detach().numpy(), [ts[i].grad.numpy() for i in diff]


def check_op(name, inputs, attrs=None, diff=(), fwd=FWD, grad=GRAD):
    """Forward and the gradients of the inputs at ``diff`` against the
    JAX package's op."""
    attrs = attrs or {}
    want, head, want_g = _jax_vjp(name, inputs, attrs, diff)
    got, got_g = _port_vjp(name, inputs, attrs, diff, head)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, **fwd)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **grad)


def _rs(seed=0):
    return np.random.RandomState(seed)


def _f32(*shape, seed=0):
    return _rs(seed).standard_normal(shape).astype(np.float32)


# -- F3: Embedding ids out of range ---------------------------------------------------


def test_embedding_ids_out_of_range_match_jax():
    """A 3-row table of ones and ids [0, -1, 3, -4, 1.7]: the JAX package
    wraps -1, gives NaN rows for 3 and -4 (``jnp.take`` fills out of
    range) and truncates 1.7; the port's layer and op give the same
    rows, and the gradient reaches the in-range rows only."""
    ids = np.array([0, -1, 3, -4, 1.7], np.float32)
    table = np.ones((3, 2), np.float32)
    want = np.array([[1, 1], [1, 1], [np.nan, np.nan], [np.nan, np.nan],
                     [1, 1]], np.float32)
    jlayer = jgluon.nn.Embedding(3, 2)
    jlayer.initialize(jmx.init.One())
    np.testing.assert_array_equal(jlayer(jmx.nd.array(ids)).asnumpy(), want)
    layer = gluon.nn.Embedding(3, 2, device="cpu")
    layer.initialize(tmx.init.One())
    np.testing.assert_array_equal(
        layer(torch.from_numpy(ids)).detach().numpy(), want)
    got = tmx.nd.Embedding(tmx.nd.array(ids, ctx=tmx.cpu()),
                           tmx.nd.array(table, ctx=tmx.cpu()),
                           input_dim=3, output_dim=2)
    np.testing.assert_array_equal(got.asnumpy(), want)
    head = np.arange(10, dtype=np.float32).reshape(5, 2)
    w = torch.from_numpy(table).requires_grad_()
    out = treg.get("Embedding").forward(torch.from_numpy(ids), w)
    out.backward(torch.from_numpy(head))
    # row 0 from id 0, row 1 from id 1.7, row 2 from id -1; none from
    # ids 3 and -4
    np.testing.assert_array_equal(w.grad.numpy(), [[0, 1], [8, 9], [2, 3]])
    check_op("Embedding", [ids, table], diff=(1,), fwd=dict(rtol=0, atol=0))


@pytest.mark.parametrize("ids_dtype", [np.float32, np.int32])
def test_embedding_matches_jax(ids_dtype):
    ids = _rs(1).randint(-6, 6, size=(3, 4)).astype(ids_dtype)
    check_op("Embedding", [ids, _f32(6, 5, seed=2)],
             {"input_dim": 6, "output_dim": 5}, diff=(1,))


def test_embedding_integer_table_fills_as_jax():
    ids = np.array([0, 2, 5, -7], np.int32)
    table = np.arange(6, dtype=np.int32).reshape(3, 2)
    want = np.asarray(jreg.get("Embedding").forward(jnp.asarray(ids),
                                                    jnp.asarray(table)))
    got = treg.get("Embedding").forward(torch.from_numpy(ids),
                                        torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


def test_embedding_sparse_grad_raises_naming_s7():
    """``sparse_grad=True`` raised here until sparse storage landed (S7e);
    now the op and the layer under ``record()`` against the JAX
    package's: the same rows forward (bitwise) and a row-sparse weight
    gradient with the same rows and values (GRAD), for ids in range
    with a repeat; outside ``record()`` the op is the dense one."""
    rs = np.random.RandomState(3)
    table = rs.randn(6, 4).astype(np.float32)
    ids = np.array([[0, 2, 2], [5, 1, 2]], np.float32)
    head = rs.randn(2, 3, 4).astype(np.float32)
    got = []
    for mx, nn in ((jmx, jgluon.nn), (tmx, gluon.nn)):
        with mx.cpu():
            w = mx.nd.array(table)
            w.attach_grad()
            with mx.autograd.record():
                out = mx.nd.Embedding(mx.nd.array(ids), w, input_dim=6,
                                      output_dim=4, sparse_grad=True)
            out.backward(mx.nd.array(head))
            layer = nn.Embedding(6, 4, sparse_grad=True)
            layer.initialize()
            layer.weight.set_data(mx.nd.array(table))
            with mx.autograd.record():
                lout = layer(mx.nd.array(ids))
            lout.backward(mx.nd.array(head))
            lg = layer.weight.grad()
            assert w.grad.stype == lg.stype == "row_sparse"
            got.append([out.asnumpy(), w.grad.indices.asnumpy(),
                        w.grad.asnumpy(), lout.asnumpy(),
                        lg.indices.asnumpy(), lg.asnumpy()])
    for k, (want, have) in enumerate(zip(*got)):
        if k in (2, 5):     # the gradients
            np.testing.assert_allclose(have, want, **GRAD)
        else:               # rows, and indices by value (int32 there)
            np.testing.assert_array_equal(have, want)
    dense = treg.get("Embedding").forward(torch.tensor([0.0, 7.0]),
                                          torch.ones(3, 2), sparse_grad=True)
    assert torch.isnan(dense[1]).all()      # the dense op's fill


# -- FullyConnected ---------------------------------------------------------------------


@pytest.mark.parametrize("attrs,shape", [
    (dict(num_hidden=5), (4, 3, 2)),
    (dict(num_hidden=5, flatten=False), (4, 3, 6)),
    (dict(num_hidden=5, no_bias=True), (4, 6)),
], ids=["flatten", "last-axis", "no-bias"])
def test_fully_connected_matches_jax(attrs, shape):
    x = _f32(*shape)
    w = _f32(5, 6, seed=1)
    b = _f32(5, seed=2)
    inputs = [x, w] if attrs.get("no_bias") else [x, w, b]
    check_op("FullyConnected", inputs, attrs,
             diff=tuple(range(len(inputs))))


def test_fully_connected_bf16_in_bf16_out():
    """bf16 in, bf16 out, the product accumulated in f32: within one
    bf16 ulp of the JAX package's."""
    x = torch.from_numpy(_f32(8, 64)).bfloat16()
    w = torch.from_numpy(_f32(16, 64, seed=1)).bfloat16()
    got = treg.get("FullyConnected").forward(x, w, no_bias=True,
                                             num_hidden=16)
    want = jreg.get("FullyConnected").forward(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.float().numpy()).astype(jnp.bfloat16), no_bias=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=2 ** -7, atol=1e-2)


def test_nd_fully_connected_recipe_trains():
    """The port's twin of the repo's canonical drive recipe on the host:
    ``nd.random.normal``, ``nd.FullyConnected`` and ``record()``; the
    loss falls toward the noise floor."""
    mx = tmx
    ctx = mx.cpu()
    mx.random.seed(0)
    X = mx.nd.random.normal(0, 1, shape=(256, 16), ctx=ctx)
    y = mx.nd.random.normal(0, 1, shape=(256, 1), ctx=ctx)
    W = mx.nd.random.normal(0, 0.3, shape=(1, 16), ctx=ctx)
    W.attach_grad()
    losses = []
    for _ in range(30):
        with mx.autograd.record():
            loss = ((mx.nd.FullyConnected(X, W, no_bias=True, num_hidden=1)
                     - y) ** 2).mean()
        loss.backward()
        W[:] = W - 0.1 * W.grad
        losses.append(float(loss.asscalar()))
    assert losses[-1] < losses[0]
    assert 0.8 < losses[-1] < 1.2


# -- norms, softmaxes, losses -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization_matches_jax(mode):
    check_op("L2Normalization", [_f32(2, 3, 4, 5)], {"mode": mode},
             diff=(0,))


@pytest.mark.parametrize("axis", [-1, 1])
def test_rms_norm_matches_jax(axis):
    x = _f32(2, 6, 6)
    g = _f32(6, seed=1)
    g = g.reshape((6,) if axis == -1 else (6, 1))
    check_op("RMSNorm", [x, g], {"axis": axis, "eps": 1e-5}, diff=(0, 1))


@pytest.mark.parametrize("name,attrs", [
    ("softmin", {}), ("softmin", {"axis": 1}),
    ("SoftmaxActivation", {}), ("SoftmaxActivation", {"mode": "channel"}),
    ("smooth_l1", {"scalar": 2.0}),
])
def test_elementwise_heads_match_jax(name, attrs):
    check_op(name, [_f32(3, 4, 5)], attrs, diff=(0,))


def test_softmax_cross_entropy_matches_jax():
    label = np.array([0, 3, 1, 4, 2], np.float32)
    check_op("softmax_cross_entropy", [_f32(5, 6), label], diff=(0,))


@pytest.mark.parametrize("attrs", [
    {}, {"grad_scale": 0.5, "normalization": "batch"},
    {"use_ignore": True, "ignore_label": 2.0, "normalization": "valid"},
    {"use_ignore": True, "ignore_label": 1.0},
], ids=["null", "batch", "valid-ignore", "ignore"])
def test_softmax_output_matches_jax(attrs):
    """The forward is the softmax; the backward ignores the head and
    gives ``(p - onehot) * scale`` under the JAX package's rules."""
    label = np.array([0, 2, 1, 3, 2, 1], np.float32)
    check_op("SoftmaxOutput", [_f32(6, 4), label], attrs, diff=(0,))


# -- attention helpers, UpSampling, BilinearSampler ------------------------------------


def test_interleaved_selfatt_match_jax():
    t, b, heads, d = 5, 2, 3, 4
    qkv = _f32(t, b, 3 * heads * d)
    check_op("_contrib_interleaved_matmul_selfatt_qk", [qkv],
             {"heads": heads}, diff=(0,))
    att = _f32(b * heads, t, t, seed=3)
    check_op("_contrib_interleaved_matmul_selfatt_valatt", [qkv, att],
             {"heads": heads}, diff=(0, 1))


@pytest.mark.parametrize("attrs", [{}, {"axis": 1, "start": 2.0,
                                        "step": 0.5}])
def test_arange_like_and_div_sqrt_dim_match_jax(attrs):
    check_op("_contrib_arange_like", [_f32(3, 4)], attrs, fwd=dict(
        rtol=0, atol=0))
    check_op("_contrib_div_sqrt_dim", [_f32(3, 5)], diff=(0,))


def test_contrib_namespace_names_the_ops():
    x = tmx.nd.array(_f32(2, 9), ctx=tmx.cpu())
    got = tmx.nd.contrib.div_sqrt_dim(x).asnumpy()
    np.testing.assert_allclose(got, _f32(2, 9) / 3.0, **FWD)
    assert "arange_like" in dir(tmx.nd.contrib)
    with pytest.raises(AttributeError):
        tmx.nd.contrib.no_such_op


def test_upsampling_matches_jax():
    check_op("UpSampling", [_f32(2, 3, 4, 5)], {"scale": 3,
                                                "sample_type": "bilinear"},
             diff=(0,), fwd=dict(rtol=0, atol=0))


def test_bilinear_sampler_matches_jax():
    data = _f32(2, 3, 5, 6)
    grid = _rs(4).uniform(-1.2, 1.2, size=(2, 2, 4, 3)).astype(np.float32)
    check_op("BilinearSampler", [data, grid], diff=(0, 1))


# -- AMP ----------------------------------------------------------------------------------


AMP_CASES = [
    ("FullyConnected", [(4, 6), (5, 6), (5,)], {"num_hidden": 5}),
    ("Deconvolution", [(1, 2, 3, 3), (2, 3, 2, 2)],
     {"kernel": (2, 2), "num_filter": 3}),
    ("softmin", [(2, 5)], {}),
    ("SoftmaxActivation", [(2, 5)], {}),
    ("L2Normalization", [(2, 5)], {}),
    ("RMSNorm", [(2, 5), (5,)], {}),
    ("smooth_l1", [(2, 5)], {}),
    ("_contrib_interleaved_matmul_selfatt_qk", [(3, 1, 6)], {}),
    ("_linalg_gemm2", [(3, 4), (4, 2)], {}),
    ("_npi_einsum", [(3, 4), (4, 2)], {"subscripts": "ij,jk->ik"}),
]


@pytest.mark.parametrize("name,shapes,attrs", AMP_CASES,
                         ids=[c[0] for c in AMP_CASES])
def test_amp_lists_cast_as_in_jax(name, shapes, attrs):
    """Under ``amp.init("bfloat16")`` each op of AMP's lists computes in
    the dtype the JAX package's dispatcher gives it: bf16 for the
    target list, f32 for the f32 list (from bf16 inputs)."""
    target = name in ("FullyConnected", "Deconvolution", "_linalg_gemm2",
                      "_npi_einsum",
                      "_contrib_interleaved_matmul_selfatt_qk")
    src = "float32" if target else "bfloat16"
    arrays = [_f32(*s, seed=i) for i, s in enumerate(shapes)]
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    try:
        jout = getattr(jmx.nd, name)(
            *[jmx.nd.array(a).astype(src) for a in arrays], **attrs)
        tout = getattr(tmx.nd, name)(
            *[tmx.nd.array(a, ctx=tmx.cpu()).astype(src) for a in arrays],
            **attrs)
    finally:
        jamp.turn_off()
        tamp.turn_off()
    want = "bfloat16" if target else "float32"
    assert str(jout.dtype) == want
    assert tout.data().dtype == getattr(torch, want), tout.data().dtype
    np.testing.assert_allclose(tout.astype("float32").asnumpy(),
                               jout.astype("float32").asnumpy(),
                               rtol=2 ** -6, atol=2e-2)


def test_ops_under_amp_are_not_deferred_as_in_jax():
    """With bulking on (the engine's default) an op under AMP runs when
    it is called, as the JAX package's dispatcher runs it: a deferred op
    took its dtypes when its segment flushed, after ``turn_off()``, and
    came out f32 where the JAX package's is bf16."""
    x = tmx.nd.array(_f32(4, 6), ctx=tmx.cpu())
    w = tmx.nd.array(_f32(5, 6, seed=1), ctx=tmx.cpu())
    eng = tmx.engine.Engine.get()
    eng.flush_bulk("test")
    tamp.init("bfloat16")
    try:
        with tmx.engine.bulk(16):
            out = tmx.nd.FullyConnected(x, w, num_hidden=5, no_bias=True)
            assert out._pending is None
    finally:
        tamp.turn_off()
    assert out.data().dtype == torch.bfloat16


def test_recorded_nd_ops_take_gradients():
    """Through ``mx.nd`` under ``record()`` as through the JAX
    package's: ``L2Normalization`` then ``softmin``."""
    x = _f32(3, 4)
    xt = tmx.nd.array(x, ctx=tmx.cpu())
    xt.attach_grad()
    with tautograd.record():
        y = tmx.nd.softmin(tmx.nd.L2Normalization(xt), axis=-1)
        loss = (y * y).sum()
    loss.backward()
    xj = jmx.nd.array(x)
    xj.attach_grad()
    with jmx.autograd.record():
        yj = jmx.nd.softmin(jmx.nd.L2Normalization(xj), axis=-1)
        lj = (yj * yj).sum()
    lj.backward()
    np.testing.assert_allclose(xt.grad.asnumpy(), xj.grad.asnumpy(), **GRAD)
