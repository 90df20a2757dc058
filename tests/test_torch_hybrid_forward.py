"""Fault F7: the port's ``HybridBlock`` calls ``hybrid_forward(self, F,
x, *args, **params)`` as the JAX package's does, held against the JAX
package on the CPU.

The blocks are written once, over either package's ``gluon``, and built
in both; the port's weights are the JAX package's, copied by structural
name.  Outputs within rtol 1e-6 / atol 1e-7 and gradients within rtol
1e-5 / atol 1e-6 of the JAX package's recorded ones; inputs made by
numpy from a seed.  Covered: the block of the fault's report (a
``Dense`` child, ``F.relu``), a block with ``self.params.get`` parameters
passed by name, a nested ``hybrid_forward`` child beside a built-in
layer, ``F.contrib.box_iou``, ``hybridize()`` (unrecorded, and recorded
through the graph pair's host double), gradients under ``record()``,
``JitTrainStep`` and ``save_parameters``.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray import NDArray

TOL = dict(rtol=1e-6, atol=1e-7)
GRAD = dict(rtol=1e-5, atol=1e-6)


def _blocks(mx):
    gluon, nn = mx.gluon, mx.gluon.nn

    class Reported(gluon.HybridBlock):
        """The block of the fault's report."""

        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.fc = nn.Dense(3, in_units=4)

        def hybrid_forward(self, F, x):
            return F.relu(self.fc(x))

    class Scaled(gluon.HybridBlock):
        """Parameters from ``self.params.get``, passed by name."""

        def __init__(self, units):
            super().__init__()
            with self.name_scope():
                self.scale = self.params.get("scale", shape=(units,))
                self.shift = self.params.get("shift", shape=(1, units))

        def hybrid_forward(self, F, x, scale, shift):
            return F.broadcast_add(F.broadcast_mul(x, scale), shift)

    class Outer(gluon.HybridBlock):
        """A nested ``hybrid_forward`` child, a built-in layer and a
        contrib op; two outputs."""

        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.inner = Scaled(4)
                self.fc = nn.Dense(4, in_units=4)

        def hybrid_forward(self, F, x, boxes):
            h = F.tanh(self.fc(self.inner(x)))
            iou = F.contrib.box_iou(boxes, F.abs(boxes) + 0.5)
            return h * 2.0, F.sum(iou, axis=1)

    return Reported, Scaled, Outer


JBLOCKS = _blocks(jmx)
TBLOCKS = _blocks(tmx)


def _pair(which, *example):
    """The JAX block and the port's (on the host) with the JAX block's
    weights."""
    jnet = JBLOCKS[which]() if which != 1 else JBLOCKS[which](4)
    jmx.random.seed(which)
    jnet.initialize(jmx.init.Uniform(0.7))
    jnet(*[jmx.nd.array(e) for e in example])
    with tmx.cpu():
        net = TBLOCKS[which]() if which != 1 else TBLOCKS[which](4)
        net.initialize()
    own = net._param_handles()
    with torch.no_grad():
        for name, p in jnet._collect_params_with_prefix().items():
            own[name]._tensor.copy_(torch.from_numpy(p.data().asnumpy()))
    return jnet, net


def _x(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


def _outs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def test_the_reported_block_gives_the_jax_output():
    x = _x(2, 4)
    jnet, net = _pair(0, x)
    want = jnet(jmx.nd.array(x)).asnumpy()
    got = net(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.shape == (2, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    with tmx.cpu():
        got_nd = net(tmx.nd.array(x))
    assert isinstance(got_nd, NDArray)
    np.testing.assert_allclose(got_nd.asnumpy(), want, **TOL)


@pytest.mark.parametrize("which", [1, 2])
def test_params_get_and_nested_blocks_match_jax(which):
    x = _x(3, 4)
    args = [x] if which == 1 else [x, np.abs(_x(3, 4, seed=1))]
    jnet, net = _pair(which, *args)
    want = [o.asnumpy() for o in _outs(jnet(*[jmx.nd.array(a)
                                              for a in args]))]
    with tmx.cpu():
        got = [o.asnumpy() for o in _outs(net(*[tmx.nd.array(a)
                                                for a in args]))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def _grads(mx, net, args, attach):
    with mx.cpu():
        nds = [mx.nd.array(a) for a in args]
        for a in nds[:attach]:
            a.attach_grad()
        with mx.autograd.record():
            outs = _outs(net(*nds))
            loss = sum((o * o).sum() for o in outs)
        loss.backward()
        return loss.asnumpy(), [a.grad.asnumpy() for a in nds[:attach]]


def test_gradients_through_hybrid_forward_match_jax():
    x, boxes = _x(3, 4), np.abs(_x(3, 4, seed=1))
    jnet, net = _pair(2, x, boxes)
    jl, jg = _grads(jmx, jnet, [x, boxes], 1)
    tl, tg = _grads(tmx, net, [x, boxes], 1)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tg[0], jg[0], **GRAD)
    own = net._param_handles()
    for name, p in jnet._collect_params_with_prefix().items():
        got = own[name]._tensor.grad
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), p.grad().asnumpy(), **GRAD)


def test_hybridized_hybrid_forward_blocks_match_jax():
    """Unrecorded calls of the hybridized block (keyed, eager on the
    host), then recorded calls through the graph pair's host double: the
    JAX package's hybridized outputs and gradients."""
    x, boxes = _x(3, 4), np.abs(_x(3, 4, seed=1))
    jnet, net = _pair(2, x, boxes)
    jnet.hybridize()
    net.hybridize()
    net._graphs.pairs_on = lambda device: True
    want = [o.asnumpy() for o in jnet(jmx.nd.array(x), jmx.nd.array(boxes))]
    for _ in range(3):
        with torch.no_grad():
            got = net(torch.from_numpy(x), torch.from_numpy(boxes))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)
    jl, jg = _grads(jmx, jnet, [x, boxes], 1)
    for _ in range(3):
        tl, tg = _grads(tmx, net, [x, boxes], 1)
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        np.testing.assert_allclose(tg[0], jg[0], **GRAD)
    st = net.stats()
    assert st["captures"] == 1 and st["backward_replays"] == 2, st
    w = net.fc.weight.grad
    np.testing.assert_allclose(
        w.numpy(), jnet.fc.weight.grad().asnumpy(), **GRAD)


def test_jit_train_step_over_a_hybrid_forward_block():
    """``JitTrainStep`` over a ``hybrid_forward`` net and loss (on the
    host: its eager step) gives the recorded loss, and its sgd update is
    ``w - lr * grad``."""
    x = _x(5, 4)
    y = _x(5, 3, seed=2)
    _, net = _pair(0, x)

    class L2(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, out, label):
            return F.mean(F.square(out - label), axis=1)

    w0 = net.fc.weight.detach().clone()
    with tmx.cpu():
        with tmx.autograd.record():
            loss = L2()(net(tmx.nd.array(x)), tmx.nd.array(y)).mean()
        loss.backward()
        g = net.fc.weight.grad.clone()
        step = tmx.parallel.JitTrainStep(net, L2(), "sgd",
                                         {"learning_rate": 0.1})
        got = step.step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(loss.asscalar()),
                               rtol=1e-6)
    np.testing.assert_allclose(net.fc.weight.detach().numpy(),
                               (w0 - 0.1 * g).numpy(), rtol=1e-6,
                               atol=1e-7)


def test_save_and_load_parameters_of_a_hybrid_forward_block(tmp_path):
    x, boxes = _x(3, 4), np.abs(_x(3, 4, seed=1))
    jnet, net = _pair(2, x, boxes)
    path = os.path.join(str(tmp_path), "outer.params")
    jnet.save_parameters(path)
    with tmx.cpu():
        fresh = TBLOCKS[2]()
        fresh.initialize()
        fresh.load_parameters(path)
        a = net(tmx.nd.array(x), tmx.nd.array(boxes))
        b = fresh(tmx.nd.array(x), tmx.nd.array(boxes))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.asnumpy(), v.asnumpy())


def test_a_block_without_forward_or_hybrid_forward_raises():
    with tmx.cpu():
        blk = tmx.gluon.HybridBlock()
        with pytest.raises(NotImplementedError, match="forward"):
            blk(torch.zeros(2))
