"""The port's autograd tape and dependency engine against the JAX
package's.

The tape cases are those of ``tests/test_autograd.py`` that need no
random or ``nn`` op, each run on both packages (the port on the host)
with the same seeded inputs: both must give the reference's expected
gradients, and the two packages must agree to 1e-6 (float32; the
gradients go through the same arithmetic in another order).  Beside
them: ``grad_req``, ``grad(create_graph=True)``, ``autograd.Function``,
and the engine cases of ``tests/test_engine_exc.py`` (poisoning, the
rethrow at a wait, version bumps).
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

PACKAGES = {"jax": jmx, "torch": tmx}


def _scope(mx):
    return mx.cpu() if mx is tmx else contextlib.nullcontext()


def simple_backward(mx):
    nd, autograd = mx.nd, mx.autograd
    x = nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x).sum()
    y.backward()
    return [x.grad], [[2, 4, 6]]


def chain(mx):
    nd, autograd = mx.nd, mx.autograd
    x = nd.array([0.5])
    x.attach_grad()
    with autograd.record():
        y = nd.exp(nd.sin(x))
    y.backward()
    return [x.grad], [[np.exp(np.sin(0.5)) * np.cos(0.5)]]


def multi_path_accumulation(mx):
    nd, autograd = mx.nd, mx.autograd
    x = nd.array([3.0])
    x.attach_grad()
    with autograd.record():
        y = x * x + x * 2  # dy/dx = 2x + 2 = 8
    y.backward()
    return [x.grad], [[8.0]]


def two_leaves(mx):
    nd, autograd = mx.nd, mx.autograd
    a = nd.array([2.0])
    b = nd.array([5.0])
    a.attach_grad()
    b.attach_grad()
    with autograd.record():
        y = a * b + b
    y.backward()
    return [a.grad, b.grad], [[5.0], [3.0]]


def head_grad(mx):
    nd, autograd = mx.nd, mx.autograd
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = x * 3
    y.backward(nd.array([10.0, 100.0]))
    return [x.grad], [[30, 300]]


def detach_blocks_grad(mx):
    nd, autograd = mx.nd, mx.autograd
    x = nd.array([2.0])
    x.attach_grad()
    with autograd.record():
        y = x * x
        z = y.detach() * x  # dz/dx through the second factor only = y = 4
    z.backward()
    return [x.grad], [[4.0]]


def stop_gradient_op(mx):
    nd, autograd = mx.nd, mx.autograd
    x = nd.array([2.0])
    x.attach_grad()
    with autograd.record():
        y = nd.stop_gradient(x * x) * x
    y.backward()
    return [x.grad], [[4.0]]


def grad_function(mx):
    nd, autograd = mx.nd, mx.autograd
    x = nd.array([1.0, 2.0, 3.0])
    with autograd.record():
        x.attach_grad()
        y = (x ** 3).sum()
    g = autograd.grad(y, x)
    return [g], [3 * np.array([1, 4, 9])]


def matmul_grad(mx):
    nd, autograd = mx.nd, mx.autograd
    rng = np.random.RandomState(0)
    a_np = rng.rand(3, 4).astype(np.float32)
    b_np = rng.rand(4, 2).astype(np.float32)
    a, b = nd.array(a_np), nd.array(b_np)
    a.attach_grad()
    b.attach_grad()
    with autograd.record():
        y = nd.dot(a, b).sum()
    y.backward()
    return [a.grad, b.grad], [np.ones((3, 2)) @ b_np.T,
                              a_np.T @ np.ones((3, 2))]


def retain_graph(mx):
    nd, autograd = mx.nd, mx.autograd
    x = nd.array([2.0])
    x.attach_grad()
    with autograd.record():
        y = x * x
    y.backward(retain_graph=True)
    g1 = x.grad.asnumpy().copy()
    y.backward()
    return [nd.array(g1), x.grad], [[4.0], [4.0]]


def custom_function(mx):
    nd, autograd = mx.nd, mx.autograd

    class Sigmoid(autograd.Function):
        def forward(self, x):
            y = 1.0 / (1.0 + nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    f = Sigmoid()
    x = nd.array([0.0])
    x.attach_grad()
    with autograd.record():
        y = f(x)
    y.backward()
    return [x.grad], [[0.25]]


def nonscalar_head_and_reductions(mx):
    nd, autograd = mx.nd, mx.autograd
    rng = np.random.RandomState(1)
    x = nd.array(rng.randn(2, 3, 4).astype(np.float32))
    w = nd.array(rng.randn(4, 5).astype(np.float32))
    x.attach_grad()
    w.attach_grad()
    with autograd.record():
        h = nd.tanh(nd.dot(x, w))
        y = (h.max(axis=2) + h.mean(axis=(0, 1)).sum()) * 2
        z = nd.broadcast_mul(nd.transpose(x, axes=(1, 0, 2)).reshape((3, 8)),
                             nd.array(np.arange(8, dtype=np.float32)))
        loss = y.sum() + nd.log1p(z * z).sum() + x[1, 2].sum()
    loss.backward()
    # a head that is not a scalar gets a head gradient of ones
    with autograd.record():
        v = nd.sigmoid(x) * 3
    v.backward()
    return [w.grad, x.grad], None


def grad_reqs(mx):
    nd, autograd = mx.nd, mx.autograd
    x, y, z = nd.array([1.0, 2.0]), nd.array([3.0, 4.0]), nd.array([5.0, 6.0])
    x.attach_grad("write")
    y.attach_grad("add")
    z.attach_grad("null")
    for _ in range(2):
        with autograd.record():
            out = (x * y * z).sum()
        out.backward()
    assert z.grad is None
    return [x.grad, y.grad], [[15.0, 24.0], [10.0, 24.0]]


def second_order(mx):
    nd, autograd = mx.nd, mx.autograd
    x = nd.array([0.5, -1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = nd.sin(x) * x
        dy = autograd.grad(y, x, create_graph=True, retain_graph=True)
        dy2 = (dy * dy).sum()
    dy2.backward()
    xs = np.array([0.5, -1.0, 2.0])
    first = np.cos(xs) * xs + np.sin(xs)
    return [dy, x.grad], [first,
                          2 * first * (2 * np.cos(xs) - xs * np.sin(xs))]


def function_two_io(mx):
    nd, autograd = mx.nd, mx.autograd

    class MulAdd(autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b, a + b

        def backward(self, d_prod, d_sum):
            a, b = self.saved_tensors
            return d_prod * b + d_sum, d_prod * a + d_sum

    a, b = nd.array([1.0, 2.0]), nd.array([3.0, -1.0])
    a.attach_grad()
    b.attach_grad()
    with autograd.record():
        p, s = MulAdd()(a, b)
        loss = (p * 2 + s * s).sum()
    loss.backward()
    # [a*b*2 + (a+b)^2]' : da = 2b + 2(a+b), db = 2a + 2(a+b)
    return [a.grad, b.grad], [[14.0, 0.0], [10.0, 6.0]]


CASES = [simple_backward, chain, multi_path_accumulation, two_leaves,
         head_grad, detach_blocks_grad, stop_gradient_op, grad_function,
         matmul_grad, retain_graph, custom_function,
         nonscalar_head_and_reductions, grad_reqs, second_order,
         function_two_io]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_tape_matches_jax(case):
    results = {}
    for name, mx in PACKAGES.items():
        with _scope(mx):
            got, want = case(mx)
        got = [g.asnumpy() for g in got]
        if want is not None:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=name)
        results[name] = got
    for g, w in zip(results["torch"], results["jax"]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mx", list(PACKAGES.values()), ids=list(PACKAGES))
def test_training_mode_flags(mx):
    autograd = mx.autograd
    assert not autograd.is_training()
    with autograd.record(train_mode=True):
        assert autograd.is_training()
        assert autograd.is_recording()
        with autograd.pause():
            assert not autograd.is_recording()
        with autograd.predict_mode():
            assert not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    assert not autograd.is_recording()


def test_record_is_the_only_place_grad_mode_is_on():
    nd, autograd = tmx.nd, tmx.autograd
    torch.set_grad_enabled(True)
    with tmx.cpu():
        x = nd.array([1.0, 2.0])
        x.attach_grad()
        # outside record(): a marked leaf records nothing
        y = x * 2
        assert not y._data.requires_grad
        with autograd.record():
            assert torch.is_grad_enabled()
            h = x * x
            with autograd.pause():
                assert not torch.is_grad_enabled()
                assert not (x * 3)._data.requires_grad
        assert torch.is_grad_enabled()      # restored, not forced off
        # an op on a recorded array outside record() is not recorded
        assert not (h + 1)._data.requires_grad
        with pytest.raises(MXNetError, match="not in the recorded graph"):
            y.backward()
        h.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 4.0])


def test_freed_graph_and_bare_leaf_heads():
    nd, autograd = tmx.nd, tmx.autograd
    with tmx.cpu():
        x = nd.array([2.0, 3.0])
        x.attach_grad()
        with autograd.record():
            y = (x * x).sum()
        y.backward()
        with pytest.raises(MXNetError, match="already freed"):
            y.backward()
        # backward on a marked leaf: its gradient is the head gradient
        x.backward(nd.array([5.0, 7.0]))
        np.testing.assert_allclose(x.grad.asnumpy(), [5.0, 7.0])
        g = autograd.grad(x, x)
        np.testing.assert_allclose(g.asnumpy(), [1.0, 1.0])
        # a variable the heads do not reach gets zeros
        u = nd.array([1.0])
        u.attach_grad()
        with autograd.record():
            z = (x * 3).sum()
        np.testing.assert_allclose(autograd.grad(z, [x, u])[1].asnumpy(),
                                   [0.0])
        # grad() leaves .grad alone
        np.testing.assert_allclose(x.grad.asnumpy(), [5.0, 7.0])
        x.zero_grad()
        np.testing.assert_allclose(x.grad.asnumpy(), [0.0, 0.0])


def test_mark_variables_and_inplace_under_record():
    nd, autograd = tmx.nd, tmx.autograd
    with tmx.cpu():
        x = nd.array([1.0, 2.0])
        buf = nd.zeros((2,))
        autograd.mark_variables([x], [buf], grad_reqs="add")
        for _ in range(2):
            with autograd.record():
                y = x * 4
                y += x          # recorded: y takes the graph of y + x
            y.backward()
        np.testing.assert_allclose(buf.asnumpy(), [10.0, 10.0])


def test_function_outside_record_is_plain():
    nd, autograd = tmx.nd, tmx.autograd

    class Twice(autograd.Function):
        calls = 0

        def forward(self, x):
            Twice.calls += 1
            assert not autograd.is_recording()
            return x * 2

        def backward(self, dy):
            assert not autograd.is_recording()
            return dy * 2

    with tmx.cpu():
        x = nd.array([1.0])
        y = Twice()(x)
        assert not y._data.requires_grad and Twice.calls == 1
        x.attach_grad()
        with autograd.record():
            z = Twice()(Twice()(x))
        z.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), [4.0])


# -- the engine (tests/test_engine_exc.py) ----------------------------------

def _boom(exc):
    def fn():
        raise exc
    return fn


@pytest.mark.parametrize("mx", list(PACKAGES.values()), ids=list(PACKAGES))
def test_var_exception_rethrown_at_wait(mx):
    eng, v = mx.engine.Engine.get(), mx.engine.Var()
    with pytest.raises(ValueError):
        eng.push(_boom(ValueError("boom")), write_vars=(v,))
    # the failure is stored on the var: waiting on it rethrows, once
    with pytest.raises(ValueError):
        eng.wait_for_var(v)
    eng.wait_for_var(v)


@pytest.mark.parametrize("mx", list(PACKAGES.values()), ids=list(PACKAGES))
def test_failed_write_poisons_readers(mx):
    eng, v = mx.engine.Engine.get(), mx.engine.Var()
    with pytest.raises(RuntimeError):
        eng.push(_boom(RuntimeError("bad write")), write_vars=(v,))
    with pytest.raises(RuntimeError):
        eng.push(lambda: 1, read_vars=(v,))


@pytest.mark.parametrize("mx", list(PACKAGES.values()), ids=list(PACKAGES))
def test_write_bumps_version(mx):
    eng, v = mx.engine.Engine.get(), mx.engine.Var()
    v0 = v.version
    eng.push(lambda: 42, write_vars=(v,))
    assert v.version == v0 + 1


def test_poisoned_array_rethrows_at_its_next_read():
    eng = tmx.engine.Engine.get()
    with tmx.cpu():
        a = tmx.nd.array([1.0, 2.0])
        with pytest.raises(KeyError):
            eng.push(_boom(KeyError("lost write")), write_vars=(a._var,))
        with pytest.raises(KeyError):
            a + 1                   # an op reading the poisoned array
        (a + 1).wait_to_read()      # rethrown once
        with pytest.raises(KeyError):
            eng.push(_boom(KeyError("again")), write_vars=(a._var,))
        with pytest.raises(KeyError):
            a.wait_to_read()
        with pytest.raises(KeyError):
            eng.push(_boom(KeyError("and again")), write_vars=(a._var,))
        with pytest.raises(KeyError):
            a.asnumpy()


def test_engine_hooks_stats_and_bulk_scope():
    eng = tmx.engine.Engine.get()
    seen, syncs = [], []

    def hook(name, t0, t1):
        seen.append(name)
        assert t1 >= t0

    eng.add_hook(hook)
    eng.add_hook(hook)                       # idempotent
    eng.add_hook(syncs.append, kind="sync")
    try:
        n0 = eng.stats.ops_pushed
        with tmx.cpu(), tmx.engine.bulk(16):
            a = tmx.nd.ones((2, 2))         # no NDArray input: eager
            b = (a + 1) * 3                 # deferred into one segment
            assert eng.stats.ops_pushed == n0 + 1
            b.wait_to_read()                # flushes it as one push
            tmx.waitall()
        assert seen == ["_ones", "bulk_segment[2]"]
        assert eng.stats.ops_pushed == n0 + 2
        assert syncs == ["wait_to_read", "waitall"]
        np.testing.assert_allclose(b.asnumpy(), 6.0)
        # without an explicit scope an op hook turns implicit bulking
        # off (one span per op), as in the JAX package
        with tmx.cpu():
            c = (a + 1) * 3
        assert seen[-2:] == ["_plus_scalar", "_mul_scalar"]
        np.testing.assert_allclose(c.asnumpy(), 6.0)
    finally:
        eng.remove_hook(hook)
        eng.remove_hook(syncs.append, kind="sync")
    prev = tmx.engine.set_bulk_size(8)
    assert tmx.engine.set_bulk_size(prev) == 8
    with pytest.raises(ValueError):
        eng.add_hook(hook, kind="other")


def test_injected_push_fault_poisons_outputs():
    from mxnet_tpu_torch.testing import faults

    plan = faults.FaultPlan(seed=1, rules=[
        {"site": "engine_push", "action": "raise", "times": 1}])
    faults.install(plan)
    try:
        with tmx.cpu():
            v = tmx.engine.Var()
            with pytest.raises(faults.FaultInjected):
                tmx.engine.Engine.get().push(lambda: 1, write_vars=(v,))
            with pytest.raises(faults.FaultInjected):
                tmx.engine.Engine.get().wait_for_var(v)
    finally:
        faults.uninstall()
