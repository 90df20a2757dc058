"""O5's and O6's f32 mode (the layers' activation quantized in the
kernels' load) on the CPU: the wrappers' plain version, the route and
split plan, and the int8 layers against the JAX package's.

- ``int8_gemm``/``int8_conv`` with ``scale`` on CPU tensors equal
  ``quantize_int8`` followed by the s8 product bit for bit, in any
  strides (permuted and sliced views), with +-inf clamped to +-127;
- ``QuantizedConv2D`` (channels-last and channel-first, the stem's
  geometry, groups) and ``QuantizedDense`` equal the JAX layers' ``fn(raw)``
  at the same int8 weights and thresholds within 1 ulp, as
  ``test_torch_quantization.py`` holds them (XLA may divide by the
  product of the scales as a multiply); dilation against the JAX
  package's registered ``_contrib_quantized_conv`` (its layer drops
  ``dilate``, R11), bitwise;
- the layers hand the f32 activation and its scale to the wrappers and
  call no ``quantize_int8`` of their own;
- ``plan_wgmma`` covers every K tile with non-empty splits.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import int8_ops as io


def _f32(shape, seed, infs=False):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal(shape) * 2).astype(np.float32)
    ties = rs.rand(*shape) < 0.25
    x[ties] = (rs.randint(-140, 140, int(ties.sum())) + 0.5) / 32
    if infs:
        x.reshape(-1)[::37] = np.inf
        x.reshape(-1)[5::41] = -np.inf
    return torch.from_numpy(x)


def _s8(shape, seed):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(-127, 128, shape).astype(np.int8))


# -- the wrappers' f32 mode ------------------------------------------------------


@pytest.mark.parametrize("scale", [32.0, 127.0 / 4.1])
@pytest.mark.parametrize("view", ["contiguous", "permuted", "sliced"])
def test_int8_conv_f32_mode_equals_quantize_then_plain(scale, view):
    base = _f32((2, 9, 10, 16), 1, infs=True)
    x = {"contiguous": base,
         "permuted": base.permute(0, 3, 1, 2).contiguous()
         .permute(0, 2, 3, 1),
         "sliced": _f32((2, 9, 10, 20), 2)[..., 2:18]}[view]
    w = _s8((12, 3, 3, 8), 3)
    bias = torch.from_numpy(np.random.RandomState(4).standard_normal(12)
                            .astype(np.float32))
    for kwargs in (dict(bias=bias, denom=7.5), dict(denom=7.5), {}):
        if "denom" not in kwargs:
            kwargs = dict(bias=torch.arange(12, dtype=torch.int32))
        got = io.int8_conv(x, w, (2, 1), (1, 1), (1, 2), 2, scale=scale,
                           **kwargs)
        want = io.int8_conv_ref(io.quantize_int8(x, scale).contiguous(), w,
                                (2, 1), (1, 1), (1, 2), 2, **kwargs)
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_int8_gemm_f32_mode_equals_quantize_then_plain():
    a = _f32((7, 40), 5, infs=True)[:, 3:35]
    b = _s8((9, 32), 6)
    got = io.int8_gemm(a, b, denom=3.0, scale=25.4)
    want = io.int8_gemm_ref(io.quantize_int8(a, 25.4), b, denom=3.0)
    assert torch.equal(got, want)
    q = io.quantize_int8(a, 25.4)
    assert q.abs().max() == 127 and (q[a == np.inf] == 127).all() \
        and (q[a == -np.inf] == -127).all()


def test_f32_mode_refuses_what_it_does_not_take():
    w = _s8((4, 3, 3, 4), 1)
    with pytest.raises(MXNetError, match="float"):
        io.int8_conv(_s8((1, 5, 5, 4), 2), w, scale=2.0)
    with pytest.raises(MXNetError, match="int8"):
        io.int8_conv(_f32((1, 5, 5, 4), 2), w)


# -- the route and the split plan ---------------------------------------------


def test_route_for_names_the_shapes_the_wgmma_route_does_not_take():
    assert io.route_for(True, 3, 1, 4, 16) == "wgmma"       # the stem
    assert io.route_for(True, 1, 32, 0, 0) == "mma_sync"    # depthwise
    assert io.route_for(False, 1, 32, 0, 0) == "mma_sync"
    assert io.route_for(False, 64, 1, 0, 16) == "wgmma"
    assert io.route_for(False, 24, 1, 0, 16) == "mma_sync"  # C/G 24
    assert io.route_for(False, 64, 1, 1, 16) == "mma_sync"  # misaligned


@pytest.mark.parametrize("m,og,groups,k", [
    (256, 1000, 1, 2048), (32, 1000, 1, 2048), (2, 1000, 1, 2048),
    (4096, 3072, 1, 768), (98, 512, 1, 4608), (802816, 64, 1, 64),
    (3136, 2048, 1, 512), (1, 1, 1, 16), (50, 64, 2, 288),
    (12544, 512, 1, 4608)])
def test_plan_wgmma_covers_every_k_tile_with_non_empty_splits(m, og, groups,
                                                              k):
    sms = 132
    bn, splits = io.plan_wgmma(m, og, groups, k, sms)
    assert bn in (64, 128, 256) and (bn < 256 or m > 1024)
    ktiles = -(-k // 128)
    kper = -(-ktiles // splits)
    assert 1 <= splits <= io.MAX_SPLITS and (splits - 1) * kper < ktiles
    assert splits * kper >= ktiles
    tiles = -(-m // 128) * -(-og // bn) * groups
    if tiles >= sms or ktiles < 2:
        assert splits == 1
    else:
        assert splits > 1


# -- the layers against the JAX package's ------------------------------------------


def _conv_pair(shape_w, kw, layout, seed, use_bias=True):
    rs = np.random.RandomState(seed)
    w = rs.standard_normal(shape_w).astype(np.float32)
    b = rs.standard_normal(shape_w[0]).astype(np.float32)
    jmx.random.seed(seed)
    jc = jnn.Conv2D(shape_w[0], shape_w[2:], in_channels=shape_w[1]
                    * kw.get("groups", 1), use_bias=use_bias, **kw)
    jc.initialize()
    jc.weight.set_data(jnd.array(w))
    if use_bias:
        jc.bias.set_data(jnd.array(b))
    tc = nn.Conv2D(shape_w[0], shape_w[2:], in_channels=shape_w[1]
                   * kw.get("groups", 1), layout=layout, use_bias=use_bias,
                   device="cpu", **kw)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(w))
        if use_bias:
            tc.bias.copy_(torch.from_numpy(b))
    return jc, tc


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", ["stem", "3x3 groups 2", "1x1 stride 2"])
def test_quantized_conv2d_matches_jax_layer(layout, case):
    shape_w, kw, x_shape, thr = {
        "stem": ((8, 3, 7, 7), dict(strides=2, padding=3), (2, 3, 20, 20),
                 2.5),
        "3x3 groups 2": ((12, 8, 3, 3), dict(strides=1, padding=1,
                                             groups=2), (2, 16, 9, 9), 3.0),
        "1x1 stride 2": ((16, 32, 1, 1), dict(strides=2), (3, 32, 8, 8),
                         1.7)}[case]
    jc, tc = _conv_pair(shape_w, kw, layout, 11)
    x = _f32(x_shape, 12).numpy()
    want = jq.QuantizedConv2D(jc, thr)(jnd.array(x)).asnumpy()
    tq_layer = tq.QuantizedConv2D(tc, thr)
    xin = torch.from_numpy(x if layout == "NCHW"
                           else x.transpose(0, 2, 3, 1).copy())
    got = tq_layer(xin).detach()
    if layout == "NHWC":
        got = got.permute(0, 3, 1, 2)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_quantized_conv2d_dilation_matches_the_registered_op(layout):
    import jax.numpy as jnp

    _, tc = _conv_pair((6, 4, 3, 3), dict(strides=1, padding=2,
                                          dilation=2), layout, 13)
    x = _f32((2, 4, 10, 10), 14).numpy()
    q = tq.QuantizedConv2D(tc, 2.0)
    xin = torch.from_numpy(x if layout == "NCHW"
                           else x.transpose(0, 2, 3, 1).copy())
    got = q(xin).detach()
    if layout == "NHWC":
        got = got.permute(0, 3, 1, 2)
    xq = np.clip(np.round(x * np.float32(q._x_scale)), -127, 127) \
        .astype(np.int8)
    acc = jreg.get("_contrib_quantized_conv").forward(
        jnp.asarray(xq), jnp.asarray(q._w_q.numpy().transpose(0, 3, 1, 2)),
        None, jnp.float32(-1), jnp.float32(1), jnp.float32(-1),
        jnp.float32(1), kernel=(3, 3), stride=(1, 1), pad=(2, 2),
        dilate=(2, 2), num_filter=6, no_bias=True)[0]
    want = np.asarray(acc).astype(np.float32) / np.float32(q._denom) \
        + tc.bias.detach().numpy()[None, :, None, None]
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_dense_matches_jax_layer_with_inf_inputs():
    jmx.random.seed(5)
    jd = jnn.Dense(10, in_units=48)
    jd.initialize(jmx.init.Xavier())
    w = jd.weight.data().asnumpy()
    b = np.random.RandomState(6).standard_normal(10).astype(np.float32)
    jd.bias.set_data(jnd.array(b))
    td = nn.Dense(10, in_units=48, device="cpu")
    with torch.no_grad():
        td.weight.copy_(torch.from_numpy(w))
        td.bias.copy_(torch.from_numpy(b))
    x = _f32((5, 3, 4, 4), 7, infs=True).numpy()
    want = jq.QuantizedDense(jd, 2.2)(jnd.array(x)).asnumpy()
    got = tq.QuantizedDense(td, 2.2)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_layers_hand_the_f32_activation_to_the_kernels(monkeypatch):
    """No ``quantize_int8`` outside the wrappers: the layers pass the f32
    activation (a channel-first one as an NHWC view) and its scale."""
    seen = []

    def no_quantize(*a, **k):
        raise AssertionError("the layer quantized outside the wrapper")

    def spy(fn):
        def wrapped(x, *a, **k):
            seen.append((fn.__name__, x.dtype, k.get("scale"),
                         x.is_contiguous()))
            with monkeypatch.context() as m:
                m.setattr(io, "quantize_int8", real_quantize)
                return fn(x, *a, **k)
        return wrapped

    real_quantize = io.quantize_int8
    monkeypatch.setattr(io, "int8_conv", spy(io.int8_conv))
    monkeypatch.setattr(io, "int8_gemm", spy(io.int8_gemm))
    monkeypatch.setattr(io, "quantize_int8", no_quantize)
    _, tc = _conv_pair((4, 3, 3, 3), dict(strides=1, padding=1), "NCHW", 8)
    tq.QuantizedConv2D(tc, 2.0)(_f32((1, 3, 6, 6), 9))
    td = nn.Dense(5, in_units=12, device="cpu")
    td.initialize()
    tq.QuantizedDense(td, 2.0)(_f32((2, 12), 10))
    assert [(n, d, s is not None) for n, d, s, _ in seen] == [
        ("int8_conv", torch.float32, True), ("int8_gemm", torch.float32,
                                             True)]
    assert seen[0][3] is False      # the NCHW input as an NHWC view
