"""The port's transposed convolutions against the JAX package's, on the
CPU: the ``Deconvolution`` op (forward and the gradients of data,
weight and bias, through ``jax.vjp`` of the JAX op), the layers
``Conv1DTranspose``, ``Conv2DTranspose``, ``Conv3DTranspose`` and
``ReflectionPad2D`` (weights carried across in a ``.params`` file),
and one D step and one G step of the JAX example's own DCGAN nets
(``examples/gan/train_dcgan.py``) against the same nets built from the
port's ``gluon.nn``.

The op's cases cover what torch's ``conv_transpose`` does not take as
it is (``adj`` at or above the stride, the negative pad of a large
``target_shape``) beside groups, dilation and the 1-d and 3-d forms.

Tolerances (f32): rtol 1e-5 / atol 1e-5 forward, rtol 1e-4 / atol 1e-5
for gradients; the DCGAN step's losses within 1e-5 relative and its
weights after both Trainer steps within 1e-5 of the largest weight.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _f32(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


# -- the op --------------------------------------------------------------------------


OP_CASES = [
    ("basic", (2, 4, 5, 6), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=3)),
    ("adj-below-stride", (2, 4, 5, 6), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=3)),
    ("adj-at-or-above-stride", (2, 4, 5, 6), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(3, 2),
          num_filter=3)),
    ("target-shape", (2, 4, 5, 6), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 1), pad=(0, 1), target_shape=(10, 7),
          num_filter=3)),
    ("target-shape-beyond-full", (2, 4, 5, 6), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 1), target_shape=(16, 11),
          num_filter=3)),
    ("groups", (2, 6, 4, 5), (6, 2, 2, 3),
     dict(kernel=(2, 3), stride=(1, 2), pad=(0, 1), num_group=3,
          num_filter=6)),
    ("dilation", (1, 4, 5, 5), (4, 2, 3, 3),
     dict(kernel=(3, 3), stride=(1, 1), dilate=(2, 3), pad=(2, 1),
          num_group=2, num_filter=4)),
    ("dilation-adj", (1, 2, 4, 4), (2, 3, 2, 2),
     dict(kernel=(2, 2), stride=(1, 1), dilate=(3, 2), adj=(2, 1),
          num_filter=3)),
    ("1d", (2, 3, 7), (3, 4, 4),
     dict(kernel=(4,), stride=(3,), pad=(1,), adj=(2,), num_filter=4,
          layout="NCW")),
    ("3d", (1, 2, 3, 4, 3), (2, 2, 2, 3, 2),
     dict(kernel=(2, 3, 2), stride=(2, 1, 2), pad=(0, 1, 1), num_filter=2,
          layout="NCDHW")),
]


def _jax_deconv(x, w, b, attrs, head):
    fwd = jreg.get("Deconvolution").forward

    def f(x, w, b):
        return fwd(x, w, b, no_bias=False, **attrs)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(head))]


@pytest.mark.parametrize("name,xs,ws,attrs", OP_CASES,
                         ids=[c[0] for c in OP_CASES])
def test_deconvolution_matches_jax(name, xs, ws, attrs):
    x, w = _f32(xs, 1), _f32(ws, 2)
    b = _f32((attrs["num_filter"],), 3)
    fwd = jreg.get("Deconvolution").forward
    shape = fwd(jnp.asarray(x), jnp.asarray(w), **attrs).shape
    head = _f32(shape, 4)
    want, want_g = _jax_deconv(x, w, b, attrs, head)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = treg.get("Deconvolution").forward(*ts, no_bias=False, **attrs)
    got.backward(torch.from_numpy(head))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), g, **GRAD)


def test_deconvolution_default_has_no_bias_and_nd_name():
    """``no_bias`` defaults to True, as in the JAX package; ``nd.
    Deconvolution`` and its alias run the op."""
    x, w = _f32((1, 2, 3, 3), 1), _f32((2, 3, 2, 2), 2)
    want = np.asarray(jreg.get("Deconvolution").forward(
        jnp.asarray(x), jnp.asarray(w), jnp.ones(3), kernel=(2, 2)))
    for name in ("Deconvolution", "deconvolution"):
        got = getattr(tmx.nd, name)(
            tmx.nd.array(x, ctx=tmx.cpu()), tmx.nd.array(w, ctx=tmx.cpu()),
            tmx.nd.ones((3,), ctx=tmx.cpu()), kernel=(2, 2), num_filter=3)
        np.testing.assert_allclose(got.asnumpy(), want, **FWD)


@pytest.mark.parametrize("layout", ["NHWC", "NWC", "NDHWC"])
def test_deconvolution_channels_last_raises_as_jax(layout):
    nd_ = len(layout) - 2
    x = np.zeros((1,) + (3,) * nd_ + (2,), np.float32)
    w = np.zeros((2, 2) + (2,) * nd_, np.float32)
    attrs = dict(kernel=(2,) * nd_, num_filter=2, layout=layout)
    with pytest.raises(ValueError, match="channel-first"):
        jreg.get("Deconvolution").forward(jnp.asarray(x), jnp.asarray(w),
                                          **attrs)
    with pytest.raises(ValueError, match="channel-first"):
        treg.get("Deconvolution").forward(torch.from_numpy(x),
                                          torch.from_numpy(w), **attrs)


# -- the layers ----------------------------------------------------------------------


LAYER_CASES = [
    ("Conv1DTranspose", dict(channels=4, kernel_size=3, strides=2,
                             padding=1, output_padding=1), (2, 3, 6)),
    ("Conv2DTranspose", dict(channels=6, kernel_size=(3, 2),
                             strides=(2, 1), padding=(1, 0),
                             output_padding=(1, 0), groups=2),
     (2, 4, 5, 4)),
    ("Conv2DTranspose", dict(channels=3, kernel_size=4, strides=2,
                             padding=1, dilation=2, output_padding=2,
                             use_bias=False, activation="tanh"),
     (2, 2, 4, 4)),
    ("Conv3DTranspose", dict(channels=2, kernel_size=2, strides=(1, 2, 1),
                             padding=(0, 1, 0)), (1, 3, 3, 4, 3)),
]


def _carry(jlayer, layer, tmp_path, x):
    """The JAX layer's parameters into the port layer through a
    ``.params`` file (the port layer deferred until it is loaded)."""
    jlayer(jmx.nd.array(x))
    f = str(tmp_path / "layer.params")
    jlayer.save_parameters(f)
    layer.load_parameters(f)


@pytest.mark.parametrize("cls,kw,shape", LAYER_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(LAYER_CASES)])
def test_transposed_layers_match_jax(cls, kw, shape, tmp_path):
    """Deferred ``in_channels``, the JAX package's names and weight
    shapes (C_in, C_out / groups, *kernel), output and gradients."""
    jmx.random.seed(5)
    jlayer = getattr(jnn, cls)(**kw)
    jlayer.initialize(jmx.init.Xavier())
    layer = getattr(nn, cls)(device="cpu", **kw)
    layer.initialize()
    x = _f32(shape, 6)
    _carry(jlayer, layer, tmp_path, x)
    jparams = {k: p.data().shape
               for k, p in jlayer._collect_params_with_prefix().items()}
    tparams = {k: tuple(t.shape)
               for k, t in layer._collect_params_with_prefix().items()}
    assert tparams == jparams
    c_in, groups = shape[1], kw.get("groups", 1)
    assert tparams["weight"][:2] == (c_in, kw["channels"] // groups)
    xj = jmx.nd.array(x)
    xj.attach_grad()
    with jautograd.record():
        out = jlayer(xj)
    head = _f32(out.shape, 7)
    out.backward(jmx.nd.array(head))
    xt = torch.from_numpy(x).requires_grad_()
    with tautograd.record():
        got = layer(xt)
    got.backward(torch.from_numpy(head))
    np.testing.assert_allclose(got.detach().numpy(), out.asnumpy(), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.asnumpy(), **GRAD)
    jg = {k: p.grad().asnumpy()
          for k, p in jlayer._collect_params_with_prefix().items()}
    for k, t in layer._collect_params_with_prefix().items():
        np.testing.assert_allclose(t.grad.numpy(), jg[k], **GRAD)


def test_transposed_layer_channels_last_raises_at_first_forward():
    """An explicit channels-last layout builds, and its first forward
    raises, in both packages (the op takes channel-first layouts only)."""
    x = np.zeros((1, 4, 4, 2), np.float32)
    jlayer = jnn.Conv2DTranspose(3, 2, layout="NHWC", in_channels=2)
    jlayer.initialize()
    with pytest.raises(ValueError, match="channel-first"):
        jlayer(jmx.nd.array(x))
    layer = nn.Conv2DTranspose(3, 2, layout="NHWC", in_channels=2,
                               device="cpu")
    layer.initialize()
    with pytest.raises(ValueError, match="channel-first"):
        layer(torch.from_numpy(x))


def test_transposed_layer_default_layout_ignores_a_channels_last_policy():
    """A transposed layer defaults to channel-first whatever the layout
    policy says, as in the JAX package (its default is NCHW, not the
    policy's)."""
    from mxnet_tpu import layout as jlayout
    from mxnet_tpu_torch import layout as tlayout

    with jlayout.layout_scope("NHWC"), tlayout.layout_scope("NHWC"):
        jl, tl = jnn.Conv2DTranspose(2, 3), nn.Conv2DTranspose(
            2, 3, device="cpu")
        assert jl._kwargs["layout"] == tl._kwargs["layout"] == "NCHW"
        assert nn.Conv2D(2, 3, device="cpu")._kwargs["layout"] == "NHWC"


@pytest.mark.parametrize("padding", [2, (0, 0, 0, 0, 1, 2, 3, 1)])
def test_reflection_pad_2d_matches_jax(padding):
    x = _f32((2, 3, 5, 6), 8)
    jlayer, layer = jnn.ReflectionPad2D(padding), nn.ReflectionPad2D(padding)
    xj = jmx.nd.array(x)
    xj.attach_grad()
    with jautograd.record():
        out = jlayer(xj)
    head = _f32(out.shape, 9)
    out.backward(jmx.nd.array(head))
    xt = torch.from_numpy(x).requires_grad_()
    got = layer(xt)
    got.backward(torch.from_numpy(head))
    np.testing.assert_array_equal(got.detach().numpy(), out.asnumpy())
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.asnumpy(), **GRAD)


# -- the JAX example's DCGAN nets ------------------------------------------------------


def _example():
    path = os.path.join(REPO, "examples", "gan", "train_dcgan.py")
    spec = importlib.util.spec_from_file_location("train_dcgan_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_generator():
    """``build_generator()`` of the example, on the port's ``gluon.nn``."""
    net = nn.HybridSequential(prefix="gen_")
    with net.name_scope():
        net.add(nn.Conv2DTranspose(64, 4, 1, 0, use_bias=False,
                                   device="cpu"),
                nn.BatchNorm(device="cpu"), nn.Activation("relu"),
                nn.Conv2DTranspose(32, 4, 2, 1, use_bias=False,
                                   device="cpu"),
                nn.BatchNorm(device="cpu"), nn.Activation("relu"),
                nn.Conv2DTranspose(1, 4, 2, 1, use_bias=False,
                                   device="cpu"),
                nn.Activation("tanh"))
    return net


def port_discriminator():
    """``build_discriminator()`` of the example, on the port's
    ``gluon.nn``."""
    net = nn.HybridSequential(prefix="disc_")
    with net.name_scope():
        net.add(nn.Conv2D(32, 4, 2, 1, use_bias=False, device="cpu"),
                nn.LeakyReLU(0.2),
                nn.Conv2D(64, 4, 2, 1, use_bias=False, device="cpu"),
                nn.BatchNorm(device="cpu"), nn.LeakyReLU(0.2),
                nn.Conv2D(1, 4, 1, 0, use_bias=False, device="cpu"),
                nn.Flatten())
    return net


def _gan_step(pkg, gen, disc, real, noise):
    """One D step then one G step, as the example runs them (Adam 2e-4,
    beta1 0.5); returns the two losses."""
    g_nd, g_ag, g_gluon = pkg
    loss_fn = g_gluon.loss.SigmoidBinaryCrossEntropyLoss()
    opts = {"learning_rate": 2e-4, "beta1": 0.5}
    d_tr = g_gluon.Trainer(disc.collect_params(), "adam", opts)
    g_tr = g_gluon.Trainer(gen.collect_params(), "adam", opts)
    bs = real.shape[0]
    ones, zeros = g_nd.ones((bs,)), g_nd.zeros((bs,))
    with g_ag.record():
        out_r = disc(real).reshape((-1,))
        fake = gen(noise)
        out_f = disc(fake.detach()).reshape((-1,))
        errd = (loss_fn(out_r, ones) + loss_fn(out_f, zeros)).mean()
    errd.backward()
    d_tr.step(bs)
    with g_ag.record():
        out = disc(gen(noise)).reshape((-1,))
        errg = loss_fn(out, ones).mean()
    errg.backward()
    g_tr.step(bs)
    return float(errd.asscalar()), float(errg.asscalar())


def test_dcgan_example_step_matches_jax(tmp_path):
    """The example's generator and discriminator (16 x 16, latent 16),
    hybridized, at batch 8 (the smallest map, 4 x 4, then holds 128
    values a channel): weights from the JAX nets through ``.params``
    files, the same noise and images; the D and G losses within 1e-5
    relative, and every weight after both Trainer steps within 1e-5 of
    its tensor's largest magnitude."""
    ex = _example()
    jmx.random.seed(0)
    jgen, jdisc = ex.build_generator(), ex.build_discriminator()
    jgen.initialize(jmx.init.Normal(0.02))
    jdisc.initialize(jmx.init.Normal(0.02))
    rs = np.random.RandomState(0)
    bs = 8
    real = ex.real_batch(rs, bs)
    noise = rs.randn(bs, ex.LATENT, 1, 1).astype(np.float32)
    jdisc(jmx.nd.array(jgen(jmx.nd.array(noise)).asnumpy()))
    gen, disc = port_generator(), port_discriminator()
    for jnet, net, name in ((jgen, gen, "gen"), (jdisc, disc, "disc")):
        f = str(tmp_path / ("%s.params" % name))
        jnet.save_parameters(f)
        net.load_parameters(f)
    for net in (jgen, jdisc, gen, disc):
        net.hybridize()
    with tmx.cpu():
        got = _gan_step((tmx.nd, tautograd, gluon), gen, disc,
                        tmx.nd.array(real), tmx.nd.array(noise))
    want = _gan_step((jmx.nd, jautograd, jgluon), jgen, jdisc,
                     jmx.nd.array(real), jmx.nd.array(noise))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for jnet, net in ((jgen, gen), (jdisc, disc)):
        jp = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
        tp = {k: t.detach().numpy()
              for k, t in net._collect_params_with_prefix().items()}
        assert sorted(tp) == sorted(jp)
        for k in jp:
            scale = max(np.abs(jp[k]).max(), 1e-30)
            err = np.abs(tp[k] - jp[k]).max() / scale
            assert err <= 1e-5, (k, err)


def test_converted_net_keeps_its_running_statistics_in_its_handles(
        tmp_path):
    """``net.double()`` (torch's ``_apply``) makes new buffers: the
    parameter handles follow them, so ``collect_params()``,
    ``_collect_params_with_prefix()`` and ``save_parameters`` see the
    running statistics a train-mode call writes afterwards (they kept
    the old f32 buffers, and the DCGAN's f64 reference run read zeros)."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, device="cpu"), nn.BatchNorm(device="cpu"))
    net.initialize()
    x = torch.from_numpy(_f32((4, 2, 5, 5), 10))
    net(x)
    net.double()
    with tautograd.record():
        net(x.double())
    mean = net[1].running_mean
    assert mean.dtype == torch.float64 and bool((mean != 0).all())
    assert net._collect_params_with_prefix()["1.running_mean"] is mean
    handle = net.collect_params()[net[1].prefix + "running_mean"]
    np.testing.assert_array_equal(handle.data().asnumpy(), mean.numpy())
    f = str(tmp_path / "net.params")
    net.save_parameters(f)
    with tmx.cpu():
        saved = tmx.nd.load(f)
    np.testing.assert_array_equal(saved["1.running_mean"].asnumpy(),
                                  mean.numpy().astype(np.float32))


def test_a_hybridized_batchnorm_net_called_twice_in_one_record_matches_eager():
    """A GAN's D step: a hybridized discriminator with BatchNorm called
    on real and then on fake images under one ``record()``.  The second
    call finds the graph pair busy and runs eagerly, writing the running
    statistics the pair's forward wrote; the backward then raised "a
    tensor ... was modified in place".  Through the pair's host double,
    the gradients and running statistics now equal the eager net's."""
    results = []
    for hybrid in (False, True):
        torch.manual_seed(3)
        net = nn.HybridSequential()
        net.add(nn.Conv2D(4, 3, device="cpu"), nn.BatchNorm(device="cpu"),
                nn.LeakyReLU(0.2), nn.Flatten())
        net.initialize()
        net(torch.zeros(2, 3, 6, 6))
        if hybrid:
            net.hybridize()
            net._graphs.pairs_on = lambda device: True
        grads = []
        for step in range(3):
            x1 = torch.from_numpy(_f32((4, 3, 6, 6), 20 + step))
            x2 = torch.from_numpy(_f32((4, 3, 6, 6), 30 + step))
            with tautograd.record():
                loss = (net(x1).sum() - 2 * net(x2).sum())
            loss.backward()
            grads.append([p.grad.clone() for p in net.parameters()])
        stats = [b.clone() for b in net.buffers()]
        results.append((grads, stats,
                        net.stats() if hybrid else None))
    (eg, es, _), (hg, hs, st) = results
    assert st["replays"] >= 2 and st["busy_calls"] >= 2, st
    for a, b in zip(eg, hg):
        for x, y in zip(a, b):
            torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6)
    for x, y in zip(es, hs):
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6)
