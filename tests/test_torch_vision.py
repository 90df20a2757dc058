"""The port's vision path against the JAX package's, on the CPU: the
convolution, pooling, BatchNorm and activation layers, ``amp``, the
``mx.nd`` ops beneath them, and small ResNets v1 and v2 in both layouts
(forward, loss, gradients, ``JitTrainStep`` with SGD momentum, and
``hybridize()`` through the graph pair's host double).

Inputs come from numpy seeds; weights are made by the JAX package and
carried across with ``vision.load_jax_params``.  The JAX side's
gradients come from its imperative autograd.

The small ResNets have two bottleneck stages (16, 32 and 64 channels)
at 32 x 32, batch 4, so that their last BatchNorm still sees 64 values
a channel: with four stages it sees 4, and the JAX package's own
compiled and imperative gradients then differ by up to 2e-4 of the
largest gradient.

Tolerances (f32): layers and ops rtol 1e-4 / atol 1e-5 (BatchNorm's
mean-1000 case says its own); the small ResNets 1e-4 of a tensor's, or
of the whole gradient's, largest magnitude; bf16 under ``amp`` within 2
bf16 ulps of the largest value.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd, nd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import gluon, layout, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision

TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, rel=1e-4):
    """Equal within ``rel`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, "error %.3g of the largest value (%.3g) > %.3g" % (
        err, scale, rel)


def _jax_layout(name, a, lay):
    """A port convolution weight (OIHW) in the JAX layer's layout."""
    if name.endswith("weight") and a.ndim >= 3 and lay[-1] == "C":
        nd_ = a.ndim - 2
        return a.transpose(*range(2, nd_ + 2), 1, 0)
    return a


def _jax_run(layer, x, head, train=True):
    """The JAX layer's output, input gradient and parameter gradients
    (its imperative autograd, train mode unless ``train`` is False)."""
    xj = nd.array(x)
    xj.attach_grad()
    with autograd.record(train_mode=train):
        out = layer(xj)
    out.backward(nd.array(head))
    grads = {k: p.grad().asnumpy()
             for k, p in layer._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xj.grad.asnumpy(), grads


def _port_run(layer, x, head, train=True):
    xt = torch.from_numpy(x).requires_grad_()
    with tautograd.record(train_mode=train):
        out = layer(xt)
    out.backward(torch.from_numpy(head))
    grads = {k: t.grad.numpy() for k, t in layer._collect_params_with_prefix().items()
             if t.requires_grad}
    return out.detach().numpy(), xt.grad.numpy(), grads


def _params(jlayer):
    return {k: p.data().asnumpy()
            for k, p in jlayer._collect_params_with_prefix().items()}


def _check_layer(jlayer, layer, x, lay="NCHW", train=True, seed=1,
                 grad_tol=None, **tol):
    """Run ``jlayer`` (initialized) on ``x``, carry its parameters into
    ``layer`` and hold outputs and gradients to it (the parameters'
    gradients to ``grad_tol`` where given)."""
    head = np.random.RandomState(seed).standard_normal(
        jlayer(nd.array(x)).shape).astype(np.float32)
    params = _params(jlayer)          # before the run updates statistics
    want, want_dx, want_g = _jax_run(jlayer, x, head, train)
    if params:
        vision.load_jax_params(layer, params, layout=lay)
    got, got_dx, got_g = _port_run(layer, x, head, train)
    tol = dict(TOL, **tol)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got_dx, want_dx, **tol)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(_jax_layout(k, got_g[k], lay), want_g[k],
                                   **(grad_tol or tol))
    return layer


# ---------------------------------------------------------------------------
# convolution


CONV_CASES = [
    ("Conv1D", dict(channels=4, kernel_size=3, strides=2, padding=1,
                    dilation=2), (2, 6, 11), "NCW"),
    ("Conv2D", dict(channels=6, kernel_size=(3, 2), strides=(2, 1),
                    padding=(1, 2), dilation=(1, 2), groups=2),
     (2, 4, 9, 8), "NCHW"),
    ("Conv3D", dict(channels=4, kernel_size=2, strides=(1, 2, 1),
                    padding=1), (1, 3, 5, 6, 4), "NCDHW"),
    ("Conv1D", dict(channels=6, kernel_size=2, dilation=3, groups=3,
                    use_bias=False), (2, 7, 3), "NWC"),
    ("Conv2D", dict(channels=6, kernel_size=3, strides=2, padding=1,
                    groups=3), (2, 7, 6, 3), "NHWC"),
    ("Conv3D", dict(channels=2, kernel_size=(1, 2, 3), padding=(0, 1, 1),
                    dilation=(1, 2, 1)), (1, 4, 5, 5, 2), "NDHWC"),
]


@pytest.mark.parametrize("cls,kw,shape,lay", CONV_CASES,
                         ids=[c[0] + "-" + c[3] for c in CONV_CASES])
def test_conv_matches_jax(cls, kw, shape, lay):
    """Stride, padding, dilation and groups in each layout: output and
    the gradients of the input, weight and bias."""
    mx.random.seed(3)
    jlayer = getattr(jnn, cls)(layout=lay, **kw)
    jlayer.initialize(mx.init.Xavier())
    jlayer.bias.set_data(nd.array(np.linspace(
        -1, 1, kw["channels"]).astype(np.float32))) \
        if kw.get("use_bias", True) else None
    layer = getattr(nn, cls)(layout=lay, device="cpu", **kw)
    x = np.random.RandomState(0).standard_normal(shape).astype(np.float32)
    _check_layer(jlayer, layer, x, lay)
    if lay in ("NHWC", "NDHWC"):
        fmt = {4: torch.channels_last, 5: torch.channels_last_3d}
        assert layer.weight.is_contiguous(
            memory_format=fmt[layer.weight.dim()])


def test_conv_deferred_in_channels_takes_the_first_input():
    """``in_channels=0``: the weight is made OIHW from the first input's
    channels and filled by ``initialize``'s initializer then."""
    layer = nn.Conv2D(5, 3, padding=1, layout="NHWC", device="cpu")
    assert isinstance(layer.weight, torch.nn.parameter.UninitializedParameter)
    gen = torch.Generator().manual_seed(0)
    layer.initialize(tmx.init.Xavier(), generator=gen)
    out = layer(torch.randn(2, 6, 6, 4))
    assert out.shape == (2, 6, 6, 5)
    assert layer.weight.shape == (5, 4, 3, 3)
    assert layer.weight.is_contiguous(memory_format=torch.channels_last)
    bound = np.sqrt(3.0 / ((4 * 9 + 5 * 9) / 2.0))
    w = layer.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.5 * bound
    with pytest.raises(MXNetError, match="initialize"):
        nn.Conv1D(2, 3, device="cpu")(torch.randn(1, 3, 8))


# ---------------------------------------------------------------------------
# pooling


POOL_CASES = [
    ("MaxPool1D", dict(pool_size=3, strides=2, padding=1), (2, 3, 9), "NCW"),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1), (2, 3, 9, 8),
     "NCHW"),
    ("MaxPool2D", dict(pool_size=2, strides=2, ceil_mode=True),
     (2, 3, 7, 7), "NCHW"),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=2), (1, 2, 5, 5),
     "NCHW"),
    ("MaxPool3D", dict(pool_size=2, strides=(1, 2, 2), padding=1),
     (1, 2, 4, 5, 5), "NCDHW"),
    ("AvgPool1D", dict(pool_size=3, strides=2, padding=1), (2, 3, 9), "NCW"),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (2, 3, 8, 9), "NCHW"),
    ("AvgPool2D", dict(pool_size=2, strides=2, ceil_mode=True),
     (2, 3, 7, 7), "NCHW"),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1, ceil_mode=True,
                       count_include_pad=False), (1, 2, 8, 8), "NCHW"),
    ("AvgPool3D", dict(pool_size=2, strides=1, padding=1,
                       count_include_pad=False), (1, 2, 3, 4, 4), "NCDHW"),
    ("GlobalMaxPool1D", {}, (2, 3, 7), "NCW"),
    ("GlobalMaxPool2D", {}, (2, 3, 5, 6), "NCHW"),
    ("GlobalMaxPool3D", {}, (1, 3, 3, 4, 5), "NCDHW"),
    ("GlobalAvgPool1D", {}, (2, 3, 7), "NCW"),
    ("GlobalAvgPool2D", {}, (2, 3, 5, 6), "NCHW"),
    ("GlobalAvgPool3D", {}, (1, 3, 3, 4, 5), "NCDHW"),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1), (2, 9, 8, 3),
     "NHWC"),
    ("AvgPool2D", dict(pool_size=2, count_include_pad=False, padding=1),
     (2, 7, 7, 3), "NHWC"),
    ("GlobalAvgPool2D", {}, (2, 5, 6, 3), "NHWC"),
]


@pytest.mark.parametrize("cls,kw,shape,lay", POOL_CASES,
                         ids=["%s-%d-%s" % (c[0], i, c[3])
                              for i, c in enumerate(POOL_CASES)])
def test_pooling_matches_jax(cls, kw, shape, lay):
    """Every pooling class, padding, ``ceil_mode`` (the ``full``
    convention, also where torch's own ceil mode would drop a window)
    and ``count_include_pad``: output and input gradient."""
    jlayer = getattr(jnn, cls)(layout=lay, **kw)
    layer = getattr(nn, cls)(layout=lay, **kw)
    x = np.random.RandomState(1).standard_normal(shape).astype(np.float32)
    _check_layer(jlayer, layer, x, lay)


# ---------------------------------------------------------------------------
# BatchNorm


def _bn_twins(axis, channels, scale=True, center=True, seed=0):
    """A JAX BatchNorm with random gamma/beta and a running mean near
    1000 (so its shifted statistics are what keeps them exact), and the
    port's copy."""
    rs = np.random.RandomState(seed)
    jlayer = jnn.BatchNorm(axis=axis, in_channels=channels, scale=scale,
                           center=center)
    jlayer.initialize()
    vals = {"gamma": rs.uniform(0.5, 1.5, channels),
            "beta": rs.standard_normal(channels),
            "running_mean": 1000.0 + rs.uniform(-0.5, 0.5, channels),
            "running_var": rs.uniform(0.5, 2.0, channels)}
    for name, v in vals.items():
        getattr(jlayer, name).set_data(nd.array(v.astype(np.float32)))
    layer = nn.BatchNorm(axis=axis, in_channels=channels, scale=scale,
                         center=center, device="cpu")
    return jlayer, layer


BN_CASES = [("train", 1, True), ("train", -1, True), ("predict", 1, True),
            ("predict", -1, True), ("train", 1, False)]


@pytest.mark.parametrize("mode,axis,scale", BN_CASES,
                         ids=["%s-axis%d-%s" % (m, a, "scale" if s else
                                                "fixgamma")
                              for m, a, s in BN_CASES])
def test_batchnorm_matches_jax(mode, axis, scale):
    """Inputs of mean 1000 and std 1 (the shifted one-pass statistics
    keep them exact; unshifted, the variance would lose about 6%):
    output, running statistics and the gradients of the input, gamma
    and beta, in train and predict mode.  The apply step ``x*scale +
    shift`` cancels ``|x| * scale`` of about 1500, so the output is held
    to 8e-4, a few f32 ulps of that; the formula's gradient of gamma
    cancels two sums of about 1e4 (``sum(dy*x)*inv`` against
    ``sum(dy)*mean*inv``, in the JAX package as here), so the
    parameters' gradients are held to 5e-3, about 40 ulps of those."""
    shape = (4, 3, 5, 6) if axis == 1 else (4, 5, 6, 3)
    jlayer, layer = _bn_twins(axis, 3, scale=scale)
    x = (1000.0 + np.random.RandomState(2).standard_normal(shape)) \
        .astype(np.float32)
    train = mode == "train"
    _check_layer(jlayer, layer, x, train=train, rtol=1e-4, atol=8e-4,
                 grad_tol=dict(rtol=1e-4, atol=5e-3))
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(
            getattr(layer, name).numpy(),
            getattr(jlayer, name).data().asnumpy(), rtol=1e-6, atol=1e-6)
    if not train:
        np.testing.assert_array_equal(layer.running_mean.numpy(),
                                      _params(jlayer)["running_mean"])


def test_batchnorm_running_var_is_the_biased_shifted_rule():
    """The running variance follows the JAX package's biased batch
    variance (``old*momentum + var*(1-momentum)``); ``F.batch_norm``'s
    unbiased update is off by M/(M-1) of the batch term and fails the
    same check (M = 8 values a channel here)."""
    jlayer, layer = _bn_twins(1, 3)
    params0 = _params(jlayer)
    vision.load_jax_params(layer, params0)
    ref_mean, ref_var = layer.running_mean.clone(), layer.running_var.clone()
    x = (1000.0 + np.random.RandomState(5).standard_normal((2, 3, 2, 2))) \
        .astype(np.float32)
    with autograd.record():
        jlayer(nd.array(x))
    want = jlayer.running_var.data().asnumpy()
    with tautograd.record():
        layer(torch.from_numpy(x))
    np.testing.assert_allclose(layer.running_var.numpy(), want, rtol=1e-5)
    # torch's rule, same input and statistics: another running variance
    F.batch_norm(torch.from_numpy(x), ref_mean, ref_var, training=True,
                 momentum=0.1, eps=1e-5)
    assert not np.allclose(ref_var.numpy(), want, rtol=1e-3)


# ---------------------------------------------------------------------------
# activations and the mx.nd ops


ACT_CASES = [
    ("Activation", ("relu",)), ("Activation", ("sigmoid",)),
    ("Activation", ("tanh",)), ("Activation", ("softrelu",)),
    ("Activation", ("softsign",)), ("LeakyReLU", (0.1,)),
    ("PReLU", ()), ("ELU", (0.7,)), ("SELU", ()), ("GELU", ()),
    ("Swish", (1.5,)),
]


@pytest.mark.parametrize("cls,args", ACT_CASES,
                         ids=["%s-%s" % (c, a[0] if a else "")
                              for c, a in ACT_CASES])
def test_activation_layers_match_jax(cls, args):
    jlayer = getattr(jnn, cls)(*args)
    jlayer.initialize()
    layer = getattr(nn, cls)(*args, **({"device": "cpu"}
                                       if cls == "PReLU" else {}))
    x = (2 * np.random.RandomState(3).standard_normal((2, 3, 4, 5))) \
        .astype(np.float32)
    _check_layer(jlayer, layer, x)


@pytest.mark.parametrize("act_type", ["gelu", "silu", "erf"])
def test_activation_op_matches_jax(act_type):
    x = np.random.RandomState(4).standard_normal((3, 7)).astype(np.float32)
    want = nd.Activation(nd.array(x), act_type=act_type).asnumpy()
    with tmx.cpu():
        got = tmx.nd.Activation(tmx.nd.array(x), act_type=act_type)
    np.testing.assert_allclose(got.asnumpy(), want, **TOL)


def test_nd_ops_match_jax_imperatively():
    """``mx.nd.Convolution`` (NHWC, HWIO weight), ``Pooling``,
    ``LeakyReLU`` and ``BatchNorm`` (three outputs; train mode from
    ``train_mode()``) on both packages' NDArrays."""
    rs = np.random.RandomState(6)
    x = rs.standard_normal((2, 6, 6, 4)).astype(np.float32)
    w = rs.standard_normal((3, 3, 4, 5)).astype(np.float32)
    b = rs.standard_normal(5).astype(np.float32)
    g, be = rs.uniform(0.5, 1.5, 4).astype(np.float32), \
        rs.standard_normal(4).astype(np.float32)
    mm, mv = rs.standard_normal(4).astype(np.float32), \
        rs.uniform(0.5, 2, 4).astype(np.float32)
    conv = dict(kernel=(3, 3), stride=(2, 1), pad=(1, 1), num_filter=5,
                layout="NHWC")
    pool = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
                layout="NHWC", count_include_pad=False)

    def run(pkg, arr):
        y = pkg.nd.Convolution(arr(x), arr(w), arr(b), **conv)
        p = pkg.nd.Pooling(y, **pool)
        act = pkg.nd.LeakyReLU(p, act_type="elu", slope=0.3)
        outs = []
        for mode in (pkg.autograd.train_mode, pkg.autograd.predict_mode):
            with mode():
                outs += pkg.nd.BatchNorm(arr(x), arr(g), arr(be), arr(mm),
                                         arr(mv), axis=-1, fix_gamma=False)
        return [o.asnumpy() for o in [y, p, act] + outs]

    want = run(mx, nd.array)
    with tmx.cpu():
        got = run(tmx, tmx.nd.array)
    assert len(got) == len(want) == 9
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a, b_, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# amp


def test_amp_casts_follow_the_jax_lists():
    """Under ``amp.init("bfloat16")`` and ``convert_hybrid_block``: the
    convolution's and the dense layer's weights are bf16 and they run in
    bf16, BatchNorm's gamma, beta and statistics stay f32 while it runs
    in its input's dtype, and the loss is taken in f32; the output is
    the JAX package's within 2 bf16 ulps of its largest value."""
    def build(pkg_nn, **kw):
        net = pkg_nn.HybridSequential()
        net.add(pkg_nn.Conv2D(8, 3, padding=1, in_channels=3, **kw),
                pkg_nn.BatchNorm(in_channels=8, **kw),
                pkg_nn.Activation("relu"), pkg_nn.GlobalAvgPool2D(),
                pkg_nn.Dense(5, in_units=8, **kw))
        return net

    mx.random.seed(7)
    jnet = build(jnn)
    jnet.initialize(mx.init.Xavier())
    net = build(nn, device="cpu")
    vision.load_jax_params(net, _params(jnet), layout="NCHW")
    x = np.random.RandomState(8).standard_normal((2, 3, 6, 6)) \
        .astype(np.float32)
    y = np.array([1, 3], np.float32)
    try:
        jamp.init("bfloat16")
        jamp.convert_hybrid_block(jnet)
        tamp.init("bfloat16")
        assert tamp.is_active()
        tamp.convert_hybrid_block(net)
        with autograd.record():
            jout = jnet(nd.array(x))
            jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(jout, nd.array(y))
        with tautograd.record():
            out = net(torch.from_numpy(x))
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(out,
                                                        torch.from_numpy(y))
    finally:
        jamp.turn_off()
        tamp.turn_off()
    dtypes = {k: t.dtype for k, t in net._collect_params_with_prefix().items()}
    assert dtypes["0.weight"] == dtypes["4.weight"] == torch.bfloat16
    assert {dtypes["1." + n] for n in ("gamma", "beta", "running_mean",
                                       "running_var")} == {torch.float32}
    jdt = {k: p.data().dtype for k, p in
           jnet._collect_params_with_prefix().items()}
    assert str(jdt["1.gamma"]) == "float32" and str(
        jdt["0.weight"]) == "bfloat16"
    assert out.dtype == torch.bfloat16 and loss.dtype == torch.float32
    want = np.asarray(jout.asnumpy(), np.float32)
    ulp = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(out.float().detach().numpy(), want,
                               atol=2 * ulp)
    np.testing.assert_allclose(loss.detach().numpy(), jloss.asnumpy(),
                               rtol=2 ** -6)
    # BatchNorm in bf16 runs in bf16: its output keeps the input's dtype
    h = net[0](torch.from_numpy(x).to(torch.bfloat16))
    assert net[1](h).dtype == torch.bfloat16


@pytest.mark.parametrize("op", ["Convolution", "FullyConnected",
                                "softmax", "mean", "broadcast_add",
                                "BatchNorm"])
def test_amp_transform_inputs_matches_jax(op):
    """Target ops to bf16, f32 ops to f32, widest-type ops to the widest
    of their inputs, other ops untouched: the dtypes the JAX package's
    dispatch-time rewrite gives the same inputs."""
    import jax.numpy as jnp

    names = ("float32", "bfloat16", "float16")
    try:
        jamp.init("bfloat16")
        tamp.init("bfloat16")
        for a in names:
            for b in names:
                want = jamp.transform_inputs(
                    op, (jnp.zeros(2, a), jnp.zeros(2, b)))
                got = tamp.transform_inputs(
                    op, (torch.zeros(2, dtype=getattr(torch, a)),
                         torch.zeros(2, dtype=getattr(torch, b)), None))
                assert [str(t.dtype).replace("torch.", "") for t in got[:2]] \
                    == [str(t.dtype) for t in want], (op, a, b)
                assert got[2] is None
    finally:
        jamp.turn_off()
        tamp.turn_off()
    x = torch.zeros(2)
    assert tamp.transform_inputs(op, (x,))[0] is x, "AMP off: untouched"


def test_amp_loss_scaler_with_the_trainer():
    """``scale_loss`` scales the loss and folds 1/scale into the
    Trainer's rescale, so a step equals the unscaled step (a power of two
    scale is exact in f32); a step whose gradients overflow is skipped,
    drops the gradients and halves the scale; ``unscale`` divides the
    gradients by the scale."""
    x = torch.from_numpy(np.random.RandomState(9).standard_normal(
        (4, 3, 6, 6)).astype(np.float32))

    def net_and_trainer():
        torch.manual_seed(0)
        net = nn.HybridSequential()
        net.add(nn.Conv2D(4, 3, in_channels=3, device="cpu"),
                nn.BatchNorm(in_channels=4, device="cpu"))
        net.initialize(tmx.init.Xavier(),
                       generator=torch.Generator().manual_seed(1))
        return net, gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1})

    def loss_of(net):
        with tautograd.record():
            return (net(x) ** 2).mean()

    plain, t_plain = net_and_trainer()
    loss_of(plain).backward()
    t_plain.step(1)
    scaled, t_scaled = net_and_trainer()
    tamp.init_trainer(t_scaled)
    scaler = t_scaled._amp_loss_scaler
    with tamp.scale_loss(loss_of(scaled), t_scaled) as big:
        big.backward()
    t_scaled.step(1)
    for (k, a), b in zip(plain._collect_params_with_prefix().items(),
                         scaled._collect_params_with_prefix().values()):
        assert torch.equal(a, b), k
    before = scaler.loss_scale
    with tamp.scale_loss(loss_of(scaled), t_scaled) as big:
        big.backward()
    scaled[0].weight.grad[0, 0, 0, 0] = float("inf")
    kept = scaled[0].weight.detach().clone()
    t_scaled.step(1)
    assert scaler.loss_scale == before / 2
    assert torch.equal(scaled[0].weight, kept)
    # the skipped step zeroes the gradients, as the JAX package's
    # p.zero_grad() does
    assert not scaled[0].weight.grad.any()
    with tamp.scale_loss(loss_of(scaled), t_scaled) as big:
        big.backward()
    g = scaled[0].weight.grad.clone()
    tamp.unscale(t_scaled)
    assert torch.equal(scaled[0].weight.grad, g / scaler.loss_scale)


def test_layout_policy_and_model_zoo_names():
    assert layout.preferred_layout(2, "cpu") == "NCHW"
    assert layout.preferred_layout(2, "cuda") == "NHWC"
    assert layout.default_layout(2) == "NCHW"
    with layout.layout_scope("channel_last"):
        assert layout.default_layout(3) == "NDHWC"
        assert nn.BatchNorm(device="cpu")._axis == -1
        assert layout.preferred_layout(1, "cpu") == "NWC"
    assert nn.BatchNorm(device="cpu")._axis == 1
    with pytest.raises(ValueError):
        layout.layout_scope("NCHWX")
    net = vision.get_model("resnet18_v1", device="cpu", classes=7)
    assert net._layout == "NCHW" and net.output.weight.shape == (7, 512)
    for name, cls in (("vgg16", vision.VGG),
                      ("densenet121", vision.DenseNet),
                      ("mobilenet1.0", vision.MobileNet),
                      ("alexnet", vision.AlexNet)):
        built = vision.get_model(name, device="cpu")
        assert type(built) is cls and built._layout == "NCHW"
    with pytest.raises(MXNetError, match="not supported"):
        vision.get_model("resnet19_v1")
    with pytest.raises(MXNetError, match="no weights"):
        vision.resnet50_v1(pretrained=True, device="cpu")


# ---------------------------------------------------------------------------
# small ResNets


SPEC = dict(layers=[1, 1], channels=[16, 32, 64], classes=10)
NETS = [(1, "NCHW"), (1, "NHWC"), (2, "NCHW"), (2, "NHWC")]
_CACHE = {}


def _batch(seed=0, n=4, size=32):
    rs = np.random.RandomState(seed)
    return ((2.0 * rs.standard_normal((n, 3, size, size)) + 3.0)
            .astype(np.float32), rs.randint(0, 10, n).astype(np.float32))


def _jax_net(version, lay):
    cls, blk = ((jvision.ResNetV1, jvision.BottleneckV1) if version == 1
                else (jvision.ResNetV2, jvision.BottleneckV2))
    mx.random.seed(10 + version)
    net = cls(blk, SPEC["layers"], SPEC["channels"], classes=SPEC["classes"],
              layout=lay)
    net.initialize(mx.init.Xavier())
    return net


def _port_net(version, lay, params):
    cls, blk = ((vision.ResNetV1, vision.BottleneckV1) if version == 1
                else (vision.ResNetV2, vision.BottleneckV2))
    net = cls(blk, SPEC["layers"], SPEC["channels"], classes=SPEC["classes"],
              layout=lay, device="cpu")
    return vision.load_jax_params(net, params)


def _reference(version, lay):
    """The JAX package's small ResNet: its initial weights, a recorded
    train-mode forward (logits, loss, gradients, running statistics
    after), a predict-mode forward with each running statistic set to
    that forward's batch statistic (so that predict mode normalises
    as train mode did), and 3 ``JitTrainStep`` SGD-momentum steps
    (weights and running statistics after)."""
    key = (version, lay)
    if key in _CACHE:
        return _CACHE[key]
    x, y = _batch()
    net = _jax_net(version, lay)
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        out = net(nd.array(x))
        loss = loss_fn(out, nd.array(y)).mean()
    loss.backward()
    allp = net._collect_params_with_prefix()
    params0 = {k: p.data().asnumpy() for k, p in allp.items()}
    for k in params0:       # the statistics as they were before the forward
        if k.endswith("running_mean"):
            params0[k] = np.zeros_like(params0[k])
        elif k.endswith("running_var"):
            params0[k] = np.ones_like(params0[k])
    ref = {"params0": params0, "logits": out.asnumpy(),
           "loss": float(loss.asscalar()),
           "grads": {k: p.grad().asnumpy() for k, p in allp.items()
                     if p.grad_req != "null"},
           "stats1": {k: p.data().asnumpy() for k, p in allp.items()
                      if "running" in k}}
    # new = 0.9 * old + 0.1 * batch, from the initial 0 and 1
    ref["batch_stats"] = {
        k: (v / 0.1 if k.endswith("mean") else (v - 0.9) / 0.1)
        .astype(np.float32) for k, v in ref["stats1"].items()}
    for k, v in ref["batch_stats"].items():
        allp[k].set_data(nd.array(v))
    with autograd.predict_mode():
        ref["predict"] = net(nd.array(x)).asnumpy()
    for k, v in params0.items():
        allp[k].set_data(nd.array(v))
    step = jparallel.JitTrainStep(net, loss_fn, "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
    ref["losses"] = [float(step.step(nd.array(x), nd.array(y)))
                     for _ in range(3)]
    step.sync_params()
    ref["params3"] = {k: p.data().asnumpy() for k, p in allp.items()}
    _CACHE[key] = ref
    return ref


def _check_updates(net, want, start, lay, rel):
    """Each tensor's change from ``start`` within ``rel`` of the largest
    change of any weight (the biases of convolutions before a BatchNorm
    take a gradient of zero up to rounding and barely move), and each
    running statistic within ``rel`` of its largest value."""
    got = net._collect_params_with_prefix()
    assert sorted(got) == sorted(want)
    moved = {k: _jax_layout(k, got[k].detach().float().numpy(), lay)
             - start[k] for k in want}
    top = max(np.abs(want[k] - start[k]).max() for k in want
              if "running" not in k)
    for k, v in want.items():
        if "running" in k:
            _close(moved[k] + start[k], v, rel)
        else:
            err = np.abs(moved[k] - (v - start[k])).max()
            assert err <= rel * top, (k, err, top)


@pytest.mark.parametrize("version,lay", NETS,
                         ids=["v%d-%s" % n for n in NETS])
def test_small_resnet_forward_and_loss_match_jax(version, lay):
    ref = _reference(version, lay)
    net = _port_net(version, lay, ref["params0"])
    x, y = _batch()
    with tautograd.record():
        out = net(torch.from_numpy(x))
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            out, torch.from_numpy(y)).mean()
    _close(out.detach().numpy(), ref["logits"])
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    params = net._collect_params_with_prefix()
    for k, v in ref["stats1"].items():
        _close(params[k].numpy(), v)
        params[k].copy_(torch.from_numpy(ref["batch_stats"][k]))
    with torch.no_grad():
        _close(net(torch.from_numpy(x)).numpy(), ref["predict"])


@pytest.mark.parametrize("version,lay", NETS,
                         ids=["v%d-%s" % n for n in NETS])
def test_small_resnet_gradients_match_jax(version, lay):
    """Every trainable gradient within 1e-4 of the largest gradient of
    the whole net (the 1x1 convolutions' biases before a BatchNorm have
    a gradient of zero up to rounding)."""
    ref = _reference(version, lay)
    net = _port_net(version, lay, ref["params0"])
    x, y = _batch()
    with tautograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(torch.from_numpy(x)), torch.from_numpy(y)).mean()
    loss.backward()
    got = {k: t.grad.numpy() for k, t in net._collect_params_with_prefix().items()
           if t.requires_grad}
    assert sorted(got) == sorted(ref["grads"])
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for k, want in ref["grads"].items():
        err = np.abs(_jax_layout(k, got[k], lay) - want).max()
        assert err <= 1e-4 * top, (k, err, top)


@pytest.mark.parametrize("version,lay", NETS,
                         ids=["v%d-%s" % n for n in NETS])
def test_small_resnet_jit_train_step_matches_jax(version, lay):
    """3 ``JitTrainStep`` steps of SGD with momentum: losses, and every
    weight and running statistic after, against the JAX package's."""
    ref = _reference(version, lay)
    net = _port_net(version, lay, ref["params0"])
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9})
    x, y = _batch()
    losses = [step.step(x, y).item() for _ in range(3)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    _check_updates(net, ref["params3"], ref["params0"], lay, 1e-4)


@pytest.mark.parametrize("version,lay", NETS,
                         ids=["v%d-%s" % n for n in NETS])
def test_small_resnet_hybridized_trainer_through_host_pairs(version, lay):
    """3 ``gluon.Trainer`` SGD-momentum steps under ``record()`` through
    the hybridized net's graph pairs (their host double: the first call
    eager, the second captures, then replays), against the same steps
    eager: weights and running statistics bitwise equal (the pair's
    in-place check passes and every step writes the statistics once),
    and a hybridized predict-mode forward after, equal to eager."""
    ref = _reference(version, lay)
    x, y = _batch(1)
    nets = []
    for hybrid in (False, True):
        net = _port_net(version, lay, ref["params0"])
        if hybrid:
            net.hybridize()
            net._graphs.pairs_on = lambda device: True
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
        for _ in range(3):
            with tautograd.record():
                loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                    net(torch.from_numpy(x)), torch.from_numpy(y)).sum()
            loss.backward()
            trainer.step(x.shape[0])
        with torch.no_grad():
            pred = net(torch.from_numpy(x))
        nets.append((net, pred))
    (eager, p_e), (hyb, p_h) = nets
    st = hyb.stats()
    assert (st["captures"], st["replays"], st["backward_replays"]) \
        == (1, 2, 2), st
    for (k, a), b in zip(eager._collect_params_with_prefix().items(),
                         hyb._collect_params_with_prefix().values()):
        assert torch.equal(a, b), k
    assert torch.equal(p_e, p_h)
    # the statistics moved from their initial values
    first = next(t for k, t in eager._collect_params_with_prefix().items()
                 if k.endswith("running_var"))
    assert not torch.equal(first, torch.ones_like(first))


def test_resnet50_v1_builds_with_the_reference_names():
    """Full ResNet-50 v1 (not run): the JAX package's 193 trainable
    parameters and 106 running statistics, under its names."""
    net = vision.resnet50_v1(device="cpu", layout="NCHW")
    params = net._collect_params_with_prefix()
    trainable = [k for k, t in params.items() if t.requires_grad]
    stats = [k for k in params if "running" in k]
    assert (len(trainable), len(stats)) == (193, 106)
    assert "features.5.3.body.7.gamma" in params
    assert "features.7.0.downsample.1.running_var" in params
