"""The port's vision families against the JAX package's, on the CPU:
AlexNet, VGG (with and without BatchNorm), SqueezeNet 1.0 and 1.1,
DenseNet, Inception-v3 and MobileNet v1 and v2, in both layouts.

Each family runs at ``classes=10`` and the smallest input its
architecture takes, or one size up where that shows more: AlexNet at
95 x 95 (its flattened map is 2 x 2, so the order of a ``Dense``
layer's columns matters), VGG at 64 x 64 (2 x 2 again), SqueezeNet at
odd sizes (47 and 39: its ``ceil_mode`` pooling rounds up there),
DenseNet at 56 x 56 (the final 7 x 7 pool), Inception-v3 at 299 x 299
(its final 8 x 8 pool needs it) and MobileNet at 32 x 32.  Where a
family's depth or width is a parameter the nets are cut: VGG to one
convolution a stage at widths 8-16, DenseNet to two blocks of two
layers (growth 8); the full-width nets of all 34 names are built and
their parameter names held against the JAX package's.

Weights are made by the JAX package and carried across with
``vision.load_jax_params`` (or a ``.params`` file).  Tolerances (f32):
logits 1e-5 of the largest logit; gradients 1e-4 of the largest
gradient; 3 ``JitTrainStep`` SGD-momentum steps: losses rtol 1e-4 and
every weight's change within 1e-4 of the largest change.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision

LAYOUTS = ("NCHW", "NHWC")

# name -> (JAX constructor, port constructor, input size, batch)
FAMILIES = {
    "alexnet": (lambda **k: jvision.AlexNet(classes=10, **k),
                lambda **k: vision.AlexNet(classes=10, **k), 95, 2),
    "vgg": (lambda **k: jvision.VGG([1] * 5, [8, 8, 16, 16, 16],
                                    classes=10, **k),
            lambda **k: vision.VGG([1] * 5, [8, 8, 16, 16, 16],
                                   classes=10, **k), 64, 2),
    "vgg_bn": (lambda **k: jvision.VGG([1] * 5, [8, 8, 16, 16, 16],
                                       classes=10, batch_norm=True, **k),
               lambda **k: vision.VGG([1] * 5, [8, 8, 16, 16, 16],
                                      classes=10, batch_norm=True, **k),
               64, 2),
    "squeezenet1.0": (lambda **k: jvision.SqueezeNet("1.0", classes=10, **k),
                      lambda **k: vision.SqueezeNet("1.0", classes=10, **k),
                      47, 2),
    "squeezenet1.1": (lambda **k: jvision.SqueezeNet("1.1", classes=10, **k),
                      lambda **k: vision.SqueezeNet("1.1", classes=10, **k),
                      39, 2),
    "densenet": (lambda **k: jvision.DenseNet(16, 8, [2, 2], classes=10, **k),
                 lambda **k: vision.DenseNet(16, 8, [2, 2], classes=10, **k),
                 56, 2),
    "inceptionv3": (lambda **k: jvision.Inception3(classes=10, **k),
                    lambda **k: vision.Inception3(classes=10, **k), 299, 1),
    "mobilenet0.25": (lambda **k: jvision.MobileNet(0.25, classes=10, **k),
                      lambda **k: vision.MobileNet(0.25, classes=10, **k),
                      32, 2),
    "mobilenetv2_0.25": (
        lambda **k: jvision.MobileNetV2(0.25, classes=10, **k),
        lambda **k: vision.MobileNetV2(0.25, classes=10, **k), 32, 2),
}
CASES = [(f, lay) for f in FAMILIES for lay in LAYOUTS]
_REF = {}


def _images(size, n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.standard_normal((n, 3, size, size)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _reference(family, lay):
    """The JAX net (seeded Xavier), its weights and its predict-mode
    logits on the family's images."""
    key = (family, lay)
    if key not in _REF:
        jmake, _, size, n = FAMILIES[family]
        mx.random.seed(3)
        jnet = jmake(layout=lay)
        jnet.initialize(mx.init.Xavier())
        x = _images(size, n)
        with autograd.predict_mode():
            logits = jnet(nd.array(x)).asnumpy()
        params = {k: p.data().asnumpy()
                  for k, p in jnet._collect_params_with_prefix().items()}
        _REF[key] = dict(net=jnet, x=x, logits=logits, params=params)
    return _REF[key]


def _port(family, lay, params, jax_layout=None):
    net = FAMILIES[family][1](layout=lay, device="cpu")
    return vision.load_jax_params(net, params, layout=jax_layout)


def _jax_layout(name, a, lay):
    """A port convolution weight (OIHW) in the JAX layer's layout."""
    if name.endswith("weight") and a.ndim == 4 and lay == "NHWC":
        return a.transpose(2, 3, 1, 0)
    return a


@pytest.mark.parametrize("family,lay", CASES,
                         ids=["%s-%s" % c for c in CASES])
def test_family_logits_match_jax(family, lay):
    ref = _reference(family, lay)
    net = _port(family, lay, ref["params"])
    assert net._layout == lay
    with torch.no_grad():
        got = net(torch.from_numpy(ref["x"])).numpy()
    assert _rel(got, ref["logits"]) <= 1e-5


@pytest.mark.parametrize("family,lay",
                         [("alexnet", "NCHW"), ("alexnet", "NHWC"),
                          ("vgg", "NCHW"), ("vgg_bn", "NHWC"),
                          ("densenet", "NHWC")])
def test_flatten_order_follows_the_layout(family, lay):
    """The JAX net's weights in the other layout: the convolutions
    change form and the first Dense layer's columns are permuted (a
    2 x 2 map: without the permutation the logits differ)."""
    other = "NHWC" if lay == "NCHW" else "NCHW"
    ref = _reference(family, other)
    net = _port(family, lay, ref["params"], jax_layout=other)
    with torch.no_grad():
        got = net(torch.from_numpy(ref["x"])).numpy()
    assert _rel(got, ref["logits"]) <= 1e-5
    if family in ("alexnet", "vgg", "vgg_bn"):
        (name, channels), = net._flat_dense.items()
        dense = net.features[int(name.split(".")[1])]
        assert dense.weight.shape[1] == 4 * channels    # a 2 x 2 map
        with torch.no_grad():
            dense.weight.copy_(torch.from_numpy(
                ref["params"][name + ".weight"]))
            unpermuted = net(torch.from_numpy(ref["x"])).numpy()
        assert _rel(unpermuted, ref["logits"]) > 1e-3


def _grads(family, lay):
    """The JAX net's and the port's gradients of the mean softmax loss
    in train mode, from the same weights."""
    ref = _reference(family, lay)
    jmake, _, size, n = FAMILIES[family]
    mx.random.seed(3)
    jnet = jmake(layout=lay)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(ref["x"]))
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(nd.array(ref["params"][k]))
    y = np.arange(n, dtype=np.float32) % 10
    with autograd.record():
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(nd.array(ref["x"])), nd.array(y)).mean()
    loss.backward()
    want = {k: p.grad().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()
            if p.grad_req != "null"}
    net = _port(family, lay, ref["params"])
    with tautograd.record():
        tloss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(torch.from_numpy(ref["x"])), torch.from_numpy(y)).mean()
    tloss.backward()
    got = {k: t.grad.numpy() for k, t in
           net._collect_params_with_prefix().items() if t.requires_grad}
    return got, want, float(tloss), float(loss.asscalar())


@pytest.mark.parametrize("family,lay",
                         [("squeezenet1.1", "NCHW"), ("squeezenet1.1", "NHWC"),
                          ("densenet", "NCHW"), ("densenet", "NHWC")])
def test_family_gradients_match_jax(family, lay):
    """Every gradient within 1e-4 of the largest: SqueezeNet (the
    dropout is off: 0.5 is a train-mode draw, so the features' dropout
    is set to 0 on both sides) and DenseNet (BatchNorm over 98 values a
    channel at the end, and the channel concat in the backward)."""
    got, want, tl, jl = _grads_without_dropout(family, lay)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert sorted(got) == sorted(want)
    top = max(np.abs(g).max() for g in want.values())
    for k, w in want.items():
        err = np.abs(_jax_layout(k, got[k], lay) - w).max()
        assert err <= 1e-4 * top, (k, err, top)


def _grads_without_dropout(family, lay):
    """``_grads`` with every Dropout of both nets at rate 0."""
    saved = (jnn.Dropout.__init__, nn.Dropout.__init__)

    def jinit(self, rate, *a, **k):
        saved[0](self, 0.0, *a, **k)

    def tinit(self, rate, *a, **k):
        saved[1](self, 0.0, *a, **k)

    jnn.Dropout.__init__, nn.Dropout.__init__ = jinit, tinit
    try:
        return _grads(family, lay)
    finally:
        jnn.Dropout.__init__, nn.Dropout.__init__ = saved


@pytest.mark.parametrize("lay", LAYOUTS)
def test_densenet_jit_train_step_matches_jax(lay):
    """3 ``JitTrainStep`` steps of SGD with momentum on the small
    DenseNet (BatchNorm, channel concats): losses, and every weight's
    change and running statistic after."""
    ref = _reference("densenet", lay)
    y = np.array([3, 7], np.float32)
    mx.random.seed(3)
    jnet = FAMILIES["densenet"][0](layout=lay)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(ref["x"]))
    allp = jnet._collect_params_with_prefix()
    for k, p in allp.items():
        p.set_data(nd.array(ref["params"][k]))
    jstep = jparallel.JitTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                   "sgd", {"learning_rate": 0.1,
                                           "momentum": 0.9})
    jl = [float(jstep.step(nd.array(ref["x"]), nd.array(y)))
          for _ in range(3)]
    jstep.sync_params()
    want = {k: p.data().asnumpy() for k, p in allp.items()}
    net = _port("densenet", lay, ref["params"])
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9})
    tl = [step.step(ref["x"], y).item() for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    got = {k: _jax_layout(k, t.detach().numpy(), lay)
           for k, t in net._collect_params_with_prefix().items()}
    start = ref["params"]
    top = max(np.abs(want[k] - start[k]).max() for k in want
              if "running" not in k)
    for k, w in want.items():
        if "running" in k:
            assert _rel(got[k], w) <= 1e-4, k
        else:
            err = np.abs((got[k] - start[k]) - (w - start[k])).max()
            assert err <= 1e-4 * top, (k, err, top)


@pytest.mark.parametrize("name", sorted(vision._models))
def test_get_model_builds_every_name_as_jax_names_its_parameters(name):
    net = vision.get_model(name, device="cpu", classes=10)
    jnet = jvision.get_model(name, classes=10, layout="NCHW")
    assert net._layout == "NCHW"
    assert sorted(net._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())


def test_get_model_names_are_the_jax_packages():
    assert sorted(vision._models) == sorted(jvision._models)
    assert len(vision._models) == 34
    with pytest.raises(MXNetError, match="not supported"):
        vision.get_model("vgg17")


def test_pretrained_loads_a_local_params_file(tmp_path):
    """``pretrained=True`` builds NCHW and loads ``root/<name>.params``
    (here the JAX package's AlexNet, saved by it); no file raises."""
    ref = _reference("alexnet", "NCHW")
    ref["net"].save_parameters(str(tmp_path / "alexnet.params"))
    net = vision.alexnet(pretrained=True, root=str(tmp_path), classes=10,
                         device="cpu")
    assert net._layout == "NCHW"
    with torch.no_grad():
        got = net(torch.from_numpy(ref["x"])).numpy()
    assert _rel(got, ref["logits"]) <= 1e-5
    for make in (vision.squeezenet1_1, vision.densenet121, vision.vgg11_bn,
                 vision.mobilenet_v2_0_5, vision.inception_v3,
                 vision.resnet18_v1):
        with pytest.raises(MXNetError, match="no weights"):
            make(pretrained=True, root=str(tmp_path / "none"),
                 device="cpu")
    assert not os.path.exists(tmp_path / "none")


@pytest.mark.parametrize("lay", LAYOUTS)
def test_pooling_edge_cases_match_jax(lay):
    """SqueezeNet's ``ceil_mode`` max pooling and Inception's padded
    average pooling (the pad counted) at odd and even sizes."""
    layers = [(lambda m, **k: m.MaxPool2D(pool_size=3, strides=2,
                                          ceil_mode=True, **k)),
              (lambda m, **k: m.AvgPool2D(pool_size=3, strides=1,
                                          padding=1, **k)),
              (lambda m, **k: m.AvgPool2D(pool_size=8, **k))]
    for size in (8, 9, 10, 11):
        x = _images(size, 2, seed=size)
        xl = x if lay == "NCHW" else x.transpose(0, 2, 3, 1).copy()
        for make in layers:
            want = make(jnn, layout=lay)(nd.array(xl)).asnumpy()
            got = make(nn, layout=lay)(torch.from_numpy(xl)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_relu6_and_depthwise_layers_match_jax():
    x = (_images(9, 2, seed=4) * 4).astype(np.float32)
    np.testing.assert_array_equal(
        vision.mobilenet.RELU6()(torch.from_numpy(x)).numpy(),
        jvision.mobilenet.RELU6()(nd.array(x)).asnumpy())
    mx.random.seed(5)
    jconv = jnn.Conv2D(3, 3, 2, 1, groups=3, use_bias=False, layout="NCHW")
    jconv.initialize(mx.init.Xavier())
    want = jconv(nd.array(x)).asnumpy()
    conv = nn.Conv2D(3, 3, 2, 1, groups=3, use_bias=False, layout="NCHW",
                     device="cpu")
    conv.initialize()
    conv(torch.from_numpy(x))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(jconv.weight.data().asnumpy()))
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
