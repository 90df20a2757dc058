"""The port's ``contrib.quantization`` against the JAX package's, on the
CPU: the calibration (``_get_optimal_threshold``, ``_Calibrator``),
``QuantizedDense``/``QuantizedConv2D`` and ``quantize_net_v2`` on a
small ResNet, with ROADMAP.md's R10 (a hybridized net is calibrated and
rebuilt) and R11 (``dilate`` is applied) in the port.

The ResNet is ``resnet18_v1(thumbnail=True, classes=10)``, batch 4 at
32 x 32, with the JAX net's weights (``vision.load_jax_params``), run
un-hybridized in both packages, naive and entropy:

- the same layers are swapped, each ``_w_scale`` is equal, the int8
  weights are bitwise equal (after OIHW -> OHWI), ``collect_params()``
  has the same keys and ``exclude_layers`` is honoured;
- each ``_x_scale`` is the JAX package's within 1e-6 relative, and the
  first layer's (which sees the data itself) bitwise: the calibration
  runs the f32 net, whose convolutions XLA and oneDNN sum in different
  orders, so a layer's largest input differs in its last bits (measured:
  16 of 21 layers, at most 6.0e-7);
- with the JAX package's thresholds (its calibrator's, handed to the
  port's ``quantize_net_v2``) the int8 logits are the JAX package's
  within 1e-5 of the largest.  For that check the BatchNorms' running
  variance is ``f32(1 - eps)`` and their mean and beta 0, with gammas
  powers of two, so that each BatchNorm is one exact product in both
  packages: XLA's ``rsqrt`` is not correctly rounded (``rsqrt(1 + 1e-5)``
  is one ulp off torch's), and one ulp in an activation turns an int8
  rounding at a .5 boundary the other way.  The port's own BatchNorm is
  held to the JAX package's in ``test_torch_vision.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu.ndarray  # noqa: F401
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision

QUANTIZED = ("QuantizedDense", "QuantizedConv2D")


# -- calibration ------------------------------------------------------------------


def _sample_sets():
    rs = np.random.RandomState(0)
    return {
        "normal": [rs.standard_normal((4, 8, 6, 6)).astype(np.float32),
                   rs.standard_normal((4, 8, 6, 6)).astype(np.float32)],
        "heavy tail": [np.concatenate([rs.standard_normal(5000),
                                       rs.standard_normal(40) * 20])
                       .astype(np.float32)],
        "relu": [np.maximum(rs.standard_normal((3, 700)), 0)
                 .astype(np.float32)],
        "zeros": [np.zeros((5, 5), np.float32)],
        "few values": [np.array([0.5, -1.0, 2.0, 1e-3], np.float32)],
    }


@pytest.mark.parametrize("name", sorted(_sample_sets()))
def test_get_optimal_threshold_equals_jax(name):
    samples = _sample_sets()[name]
    want = jq._get_optimal_threshold(samples)
    got = tq._get_optimal_threshold(samples)
    assert float(got) == float(want), (got, want)


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_calibrator_equals_jax(mode):
    jc, tc = jq._Calibrator(mode), tq._Calibrator(mode)
    for name, samples in _sample_sets().items():
        for s in samples:
            jc.observe(name, s)
            tc.observe(name, torch.from_numpy(s))
    for name in list(_sample_sets()) + ["never seen"]:
        assert float(tc.threshold(name)) == float(jc.threshold(name)), name
    with pytest.raises(MXNetError, match="naive or entropy"):
        tq._Calibrator("kl")


def test_device_histogram_bins_as_numpy_at_the_edges():
    """The calibrator's histogram (counted by the bin edges, where the
    magnitudes lie) equals ``np.histogram``'s counts, values exactly on
    the edges and at the maximum included."""
    rs = np.random.RandomState(1)
    edges = np.histogram(np.zeros(0, np.float32), bins=1001,
                         range=(0, 3.0))[1]
    vals = np.concatenate([rs.uniform(0, 3, 20000).astype(np.float32),
                           edges, np.float32([3.0, 0.0])])
    want = np.histogram(vals, bins=1001, range=(0, 3.0))[0]
    parts = [torch.from_numpy(vals[:7000]), torch.from_numpy(vals[7000:])]
    got, got_edges = tq._device_histogram(parts, 1001, 3.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_edges, edges)


# -- the small ResNet ---------------------------------------------------------------

_BATCH = (4, 3, 32, 32)
_CACHE = {}


def _reference():
    """The JAX net's weights, with BatchNorms that are exact products
    (see the module docstring), the calibration batches and the eval
    batch."""
    if "params" not in _CACHE:
        x = np.random.RandomState(1).standard_normal(_BATCH) \
            .astype(np.float32)
        jmx.random.seed(3)
        jnet = jvision.resnet18_v1(thumbnail=True, classes=10)
        jnet.initialize(jmx.init.Xavier())
        jnet(jnd.array(x))
        params = {k: p.data().asnumpy()
                  for k, p in jnet._collect_params_with_prefix().items()}
        rs = np.random.RandomState(2)
        var = np.float32(1.0) - np.float32(1e-5)
        assert var + np.float32(1e-5) == np.float32(1.0)
        for k in params:
            if k.endswith("gamma"):
                params[k] = (2.0 ** rs.randint(-1, 2, params[k].shape)) \
                    .astype(np.float32)
            elif k.endswith("running_var"):
                params[k] = np.full_like(params[k], var)
        calib = [np.random.RandomState(s).standard_normal(_BATCH)
                 .astype(np.float32) for s in (5, 6)]
        _CACHE.update(params=params, x=x, calib=calib)
    return _CACHE


def _jax_net(params):
    net = jvision.resnet18_v1(thumbnail=True, classes=10)
    net.initialize(jmx.init.Xavier())
    net(jnd.array(_reference()["x"]))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jnd.array(params[k]))
    return net


def _port_net(params):
    net = vision.resnet18_v1(thumbnail=True, classes=10, device="cpu")
    return vision.load_jax_params(net, params)


def _blocks(net, jax):
    """``{path: quantized block}`` of a quantized net."""
    out = {}

    def walk(b, path):
        kids = b._children.items() if jax else [
            (k, v) for k, v in b._modules.items()
            if isinstance(v, tmx.gluon.Block)]
        for name, c in kids:
            full = "%s.%s" % (path, name) if path else name
            if type(c).__name__ in QUANTIZED:
                out[full] = c
            else:
                walk(c, full)

    walk(net, "")
    return out


def _quantize_jax(mode, exclude=None, record=None):
    ref = _reference()
    net = _jax_net(ref["params"])
    orig = jq._Calibrator.threshold

    def threshold(self, name):
        t = orig(self, name)
        if record is not None:
            record[name] = t
        return t

    if callable(exclude):
        exclude = exclude(net)
    jq._Calibrator.threshold = threshold
    try:
        jq.quantize_net_v2(net, calib_mode=mode, exclude_layers=exclude,
                           calib_data=[jnd.array(b) for b in ref["calib"]])
    finally:
        jq._Calibrator.threshold = orig
    return net


def _quantize_port(mode, exclude=None, thresholds=None, hybridize=False):
    ref = _reference()
    net = _port_net(ref["params"])
    if hybridize:
        net.hybridize()
        with tmx.autograd.predict_mode():
            net(torch.from_numpy(ref["x"]))
    if callable(exclude):
        exclude = exclude(net)
    orig = tq._Calibrator.threshold
    if thresholds is not None:
        tq._Calibrator.threshold = lambda self, name: thresholds[name]
    try:
        tq.quantize_net_v2(net, calib_mode=mode, exclude_layers=exclude,
                           calib_data=[torch.from_numpy(b)
                                       for b in ref["calib"]])
    finally:
        tq._Calibrator.threshold = orig
    return net


def _keys(net):
    """``collect_params()``'s keys without the net's own prefix (the
    name counters differ between the packages' processes)."""
    keys = list(net.collect_params().keys())
    assert all(k.startswith(net.prefix) for k in keys)
    return [k[len(net.prefix):] for k in keys]


def _logits(net, jax):
    x = _reference()["x"]
    if jax:
        with jmx.autograd.predict_mode():
            return net(jnd.array(x)).asnumpy()
    with tmx.autograd.predict_mode():
        return net(torch.from_numpy(x)).detach().numpy()


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_net_v2_matches_jax_on_a_small_resnet(mode):
    jnet = _quantize_jax(mode)
    net = _quantize_port(mode)
    jb, tb = _blocks(jnet, True), _blocks(net, False)
    assert sorted(jb) == sorted(tb) and len(tb) == 21
    for path in jb:
        j, t = jb[path], tb[path]
        assert type(j).__name__ == type(t).__name__, path
        assert t._w_scale == j._w_scale, path
        want = np.asarray(j._w_q)
        got = t._w_q.numpy()
        if type(t).__name__ == "QuantizedConv2D":
            got = got.transpose(0, 3, 1, 2)            # OHWI -> OIHW
        assert got.dtype == want.dtype == np.int8
        np.testing.assert_array_equal(got, want, err_msg=path)
        np.testing.assert_allclose(t._x_scale, j._x_scale, rtol=1e-6,
                                   err_msg=path)
    assert tb["features.0"]._x_scale == jb["features.0"]._x_scale
    assert _keys(net) == _keys(jnet)
    got, want = _logits(net, False), _logits(jnet, True)
    assert np.isfinite(got).all() and got.shape == (4, 10)
    fp32 = _logits(_port_net(_reference()["params"]), False)
    assert np.abs(got - fp32).max() > 0     # the int8 path ran


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantized_resnet_logits_match_jax_at_its_thresholds(mode):
    thresholds = {}
    jnet = _quantize_jax(mode, record=thresholds)
    net = _quantize_port(mode, thresholds=thresholds)
    want = _logits(jnet, True)
    got = _logits(net, False)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    for path, blk in _blocks(net, False).items():
        assert blk._x_scale == _blocks(jnet, True)[path]._x_scale, path


def test_exclude_layers_by_path_and_name_as_jax():
    """Two layers named by path, the output layer by its name (each
    package's own: the names count the nets a process made)."""
    def exclude(net):
        return ["features.0", net.output.name, "features.2.0.downsample.0"]

    jnet = _quantize_jax("naive", exclude=exclude)
    net = _quantize_port("naive", exclude=exclude)
    jb, tb = _blocks(jnet, True), _blocks(net, False)
    assert sorted(jb) == sorted(tb) and len(tb) == 18
    assert type(net.features[0]) is nn.Conv2D
    assert type(net.output) is nn.Dense
    assert type(jnet.features[0]) is jnn.Conv2D
    assert _keys(net) == _keys(jnet)


def test_hybridized_net_is_calibrated_as_an_eager_one():
    """R10 in the port: a hybridized net (called once, so it is armed)
    calibrates every layer's input and, once swapped, runs the int8
    path: its thresholds and logits are an eager net's; the blocks that
    were armed stay armed and the swapped ones are armed too."""
    for mode in ("naive", "entropy"):
        eager = _quantize_port(mode)
        hyb = _quantize_port(mode, hybridize=True)
        eb, hb = _blocks(eager, False), _blocks(hyb, False)
        for path in eb:
            assert hb[path]._threshold == eb[path]._threshold, path
            assert hb[path]._active
        assert hyb._active and not eager._active
        np.testing.assert_array_equal(_logits(hyb, False),
                                      _logits(eager, False))
    fp32 = _logits(_port_net(_reference()["params"]), False)
    assert np.abs(_logits(hyb, False) - fp32).max() > 0


# -- the layers -------------------------------------------------------------------


def test_quantized_dense_matches_jax_with_activation_and_flatten():
    for flatten in (True, False):
        jmx.random.seed(4)
        jd = jnn.Dense(6, activation="relu", flatten=flatten, in_units=12
                       if flatten else 4)
        jd.initialize(jmx.init.Xavier())
        w = jd.weight.data().asnumpy()
        b = np.random.RandomState(3).standard_normal(6).astype(np.float32)
        jd.bias.set_data(jnd.array(b))
        td = nn.Dense(6, activation="relu", flatten=flatten,
                      in_units=w.shape[1], device="cpu")
        with torch.no_grad():
            td.weight.copy_(torch.from_numpy(w))
            td.bias.copy_(torch.from_numpy(b))
        jqd, tqd = jq.QuantizedDense(jd, 1.7), tq.QuantizedDense(td, 1.7)
        x = np.random.RandomState(4).standard_normal((3, 3, 4)) \
            .astype(np.float32)
        want = jqd(jnd.array(x)).asnumpy()
        got = tqd(torch.from_numpy(x)).detach().numpy()
        assert got.shape == want.shape
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        assert tqd._denom == np.float32(jqd._x_scale * jqd._w_scale)


def test_quantized_conv2d_applies_dilate_as_the_registered_op():
    """R11: the port's ``QuantizedConv2D`` of a dilated ``Conv2D`` equals
    the JAX package's registered ``_contrib_quantized_conv`` (which
    passes ``rhs_dilation``) on the same int8 values and scales, then
    the layer's dequantize and bias.  The JAX package's own layer drops
    ``dilate``: its output has the undilated shape."""
    import jax.numpy as jnp

    rs = np.random.RandomState(7)
    conv = nn.Conv2D(5, 3, strides=1, padding=1, dilation=2, in_channels=4,
                     layout="NCHW", device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            rs.standard_normal((5, 4, 3, 3)).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(
            rs.standard_normal(5).astype(np.float32)))
    x = rs.standard_normal((2, 4, 9, 9)).astype(np.float32)
    q = tq.QuantizedConv2D(conv, 2.5)
    got = q(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 5, 7, 7)

    xq = np.clip(np.round(x * np.float32(q._x_scale)), -127, 127) \
        .astype(np.int8)
    w_q = q._w_q.numpy().transpose(0, 3, 1, 2)               # OIHW
    acc = jreg.get("_contrib_quantized_conv").forward(
        jnp.asarray(xq), jnp.asarray(w_q), None, jnp.float32(-1),
        jnp.float32(1), jnp.float32(-1), jnp.float32(1), kernel=(3, 3),
        stride=(1, 1), pad=(1, 1), dilate=(2, 2), num_filter=5,
        no_bias=True)[0]
    want = np.asarray(acc).astype(np.float32) / np.float32(q._denom) \
        + conv.bias.detach().numpy()[None, :, None, None]
    np.testing.assert_array_equal(got, want)

    jconv = jnn.Conv2D(5, 3, strides=1, padding=1, dilation=2,
                       in_channels=4)
    jconv.initialize()
    jout = jq.QuantizedConv2D(jconv, 2.5)(jnd.array(x))
    assert jout.shape == (2, 5, 9, 9)      # R11: the JAX layer's shape


def test_quantized_conv2d_channels_last_equals_channel_first():
    """The same layer built NHWC (the card's layout) and NCHW gives the
    same outputs, transposed."""
    rs = np.random.RandomState(8)
    w = rs.standard_normal((6, 2, 3, 3)).astype(np.float32)
    x = rs.standard_normal((2, 4, 8, 8)).astype(np.float32)
    outs = []
    for layout in ("NCHW", "NHWC"):
        conv = nn.Conv2D(6, 3, strides=2, padding=1, groups=2,
                         in_channels=4, layout=layout, use_bias=False,
                         device="cpu")
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(w))
        xin = torch.from_numpy(x if layout == "NCHW"
                               else x.transpose(0, 2, 3, 1).copy())
        out = tq.QuantizedConv2D(conv, 3.0)(xin)
        outs.append(out if layout == "NCHW" else out.permute(0, 3, 1, 2))
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


# -- the API's edges --------------------------------------------------------------


def test_quantize_graph_and_model_raise_naming_s9():
    for fn in (tq.quantize_graph, tq.quantize_model):
        with pytest.raises(MXNetError, match="S9"):
            fn(None, {}, {})


def test_quantize_net_v2_refuses_what_the_jax_package_refuses():
    net = nn.HybridSequential()
    net.add(nn.Dense(3, in_units=4, device="cpu"))
    net.initialize()
    data = [torch.zeros(2, 4)]
    with pytest.raises(MXNetError, match="calib_data"):
        tq.quantize_net_v2(net)
    with pytest.raises(MXNetError, match="int8"):
        tq.quantize_net_v2(net, quantized_dtype="uint8", calib_data=data)
    with pytest.raises(MXNetError, match="naive or entropy"):
        tq.quantize_net_v2(net, calib_mode="none", calib_data=data)
    empty = nn.HybridSequential()
    empty.add(nn.Activation("relu"))
    with pytest.raises(MXNetError, match="no quantizable"):
        tq.quantize_net_v2(empty, calib_data=data)
    # quantize_net is quantize_net_v2; num_calib_batches stops early
    seen = []
    net[0].register_forward_pre_hook(lambda b, a: seen.append(1))
    tq.quantize_net(net, calib_data=data * 5, num_calib_batches=2)
    assert len(seen) == 2 and type(net[0]).__name__ == "QuantizedDense"
    assert tmx.contrib.quantization is tq


def test_quantize_net_v2_takes_ndarray_numpy_and_tuple_batches():
    """Calibration batches as NDArrays, numpy arrays or (data, label)
    tuples, as the README's recipe gives them; the int8 net takes and
    gives NDArrays."""
    x = np.random.RandomState(9).rand(2, 3, 16, 16).astype(np.float32)
    with tmx.cpu():
        outs = []
        for batches in ([tmx.nd.array(x)], [x], [(torch.from_numpy(x),
                                                  None)]):
            net = vision.resnet18_v1(thumbnail=True, classes=10)
            net.initialize(tmx.init.Xavier())
            tq.quantize_net_v2(net, calib_data=batches)
            out = net(tmx.nd.array(x))
            assert isinstance(out, tmx.nd.NDArray)
            assert len(_blocks(net, False)) == 21
            outs.append([b._threshold for b in _blocks(net, False)
                         .values()])
    assert all(np.isfinite(t).all() for t in outs)
