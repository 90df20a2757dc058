"""The port's ``mx.operator`` (``CustomOp``, ``CustomOpProp``,
``register``, ``nd.Custom``) against the JAX package's, on the CPU.

The same user op classes, written once over either package's ``nd``,
run in both on the same seeded inputs: outputs within rtol 1e-6, and
under ``record()`` the input gradients that the user's ``backward``
writes, within rtol 1e-6 / atol 1e-7.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-6, atol=1e-7)


def _define(mx, tag):
    """Register two user ops in package ``mx``: a sigmoid whose backward
    is written by hand, and a two-output op with a ``scale`` parameter."""

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            y = 1.0 / (1.0 + mx.nd.exp(-in_data[0]))
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    @mx.operator.register("sigmoid_" + tag)
    class SigmoidProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Sigmoid()

    class ScaleSplit(mx.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            self.assign(out_data[0], req[0], a * self.scale + b)
            self.assign(out_data[1], req[1], a * b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = in_data
            g0, g1 = out_grad
            self.assign(in_grad[0], req[0], g0 * self.scale + g1 * b)
            self.assign(in_grad[1], req[1], g0 + g1 * a)

    @mx.operator.register("scale_split_" + tag)
    class ScaleSplitProp(mx.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__()
            self.scale = float(scale)

        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "prod"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return ScaleSplit(self.scale)


_define(jmx, "t")
_define(tmx, "t")


def _run(mx, record, *arrays, **kw):
    with mx.cpu():
        nds = [mx.nd.array(a) for a in arrays]
        for x in nds:
            x.attach_grad()
        if record:
            with mx.autograd.record():
                out = mx.nd.Custom(*nds, **kw)
                outs = out if isinstance(out, (list, tuple)) else [out]
                head = sum((o * (i + 2.0)).sum() for i, o in enumerate(outs))
            head.backward()
        else:
            out = mx.nd.Custom(*nds, **kw)
            outs = out if isinstance(out, (list, tuple)) else [out]
        return ([o.asnumpy() for o in outs],
                [x.grad.asnumpy() for x in nds] if record else [])


def _x(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("record", [False, True])
def test_custom_sigmoid_matches_jax(record):
    x = _x(4, 5)
    want = _run(jmx, record, x, op_type="sigmoid_t")
    got = _run(tmx, record, x, op_type="sigmoid_t")
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_allclose(g, w, **TOL)
    if record:
        s = 1 / (1 + np.exp(-x))
        np.testing.assert_allclose(got[1][0], 2 * s * (1 - s), rtol=1e-5)


@pytest.mark.parametrize("record", [False, True])
def test_custom_two_outputs_with_a_parameter_match_jax(record):
    a, b = _x(3, 4), _x(3, 4, seed=1)
    want = _run(jmx, record, a, b, op_type="scale_split_t", scale=0.5)
    got = _run(tmx, record, a, b, op_type="scale_split_t", scale=0.5)
    assert len(got[0]) == 2
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_allclose(g, w, **TOL)


def test_custom_op_inside_a_hybrid_forward_block_records():
    """A custom op called from a ``hybrid_forward`` block runs eagerly in
    it and its backward reaches the block's parameter."""
    from mxnet_tpu_torch import gluon

    class Net(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.w = self.params.get("w", shape=(5,))

        def hybrid_forward(self, F, x, w):
            return F.Custom(x * w, op_type="sigmoid_t")

    with tmx.cpu():
        net = Net()
        net.initialize(tmx.init.Constant(0.5))
        x = tmx.nd.array(_x(4, 5))
        with tmx.autograd.record():
            y = net(x)
        y.backward()
        s = 1 / (1 + np.exp(-0.5 * x.asnumpy()))
        np.testing.assert_allclose(y.asnumpy(), s, rtol=1e-6)
        np.testing.assert_allclose(
            net.w.grad.numpy(), (s * (1 - s) * x.asnumpy()).sum(0),
            rtol=1e-5)
        net.hybridize()
        np.testing.assert_allclose(net(x).asnumpy(), s, rtol=1e-6)


def test_assign_requests_and_errors():
    op = tmx.operator.CustomOp()
    with tmx.cpu():
        dst = tmx.nd.array(np.ones(3, np.float32))
        src = tmx.nd.array(np.full(3, 2.0, np.float32))
        op.assign(dst, "null", src)
        np.testing.assert_array_equal(dst.asnumpy(), 1.0)
        op.assign(dst, "add", src)
        np.testing.assert_array_equal(dst.asnumpy(), 3.0)
        op.assign(dst, "write", src)
        np.testing.assert_array_equal(dst.asnumpy(), 2.0)
        with pytest.raises(MXNetError, match="not registered"):
            tmx.nd.Custom(dst, op_type="no_such_op")
        with pytest.raises(MXNetError, match="op_type"):
            tmx.nd.Custom(dst)
    with pytest.raises(MXNetError):
        tmx.operator.register("bad")(object)
    assert tmx.operator.get_prop_cls("sigmoid_t").__name__ == "SigmoidProp"
