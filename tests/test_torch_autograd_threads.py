"""Fault F19: one thread's ``backward`` took or cleared the gradient of
another thread's marked array.

``autograd.backward`` reads each marked array's gradient from its leaf
view after torch's backward has run.  It looked for the leaf views in
one process-wide registry, so a backward on one thread set the other
thread's leaf gradients to None, between that thread's accumulation and
its read: the other thread's ``x.grad`` then kept its old value (zeros
at the first step).  The card test file repeats the two-thread run
(``test_two_thread_gradients_equal_eager_in_forty_repeats_on_card``);
here the interleaving is forced: a hook on one thread's leaf holds its
backward right after the accumulation while the main thread runs a
whole backward of its own.  Numpy gives the expected gradients.  No JAX
is needed: the JAX package runs no threads here.
"""
import threading

import numpy as np

import mxnet_tpu_torch as mx


def _grad_of_sum_of_squares(x, w):
    # d/dw sum((x @ w)^2) = 2 x^T (x @ w)
    return 2.0 * x.T @ (x @ w)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 3)).astype(np.float32),
            rng.standard_normal((3, 2)).astype(np.float32))


def test_a_backward_on_another_thread_keeps_this_threads_gradient():
    accumulated, resume = threading.Event(), threading.Event()
    got = {}

    def held_thread():
        x, w = _arrays(1)
        with mx.cpu():
            xa, wa = mx.nd.array(x), mx.nd.array(w)
            wa.attach_grad()
            with mx.autograd.record():
                loss = (mx.nd.dot(xa, wa) ** 2).sum()

            def hold(_):
                accumulated.set()
                resume.wait(30)
            wa._leaf_view().register_post_accumulate_grad_hook(hold)
            loss.backward()
            got["held"] = wa.grad.asnumpy()

    t = threading.Thread(target=held_thread)
    t.start()
    try:
        assert accumulated.wait(30), "the held backward never accumulated"
        x, w = _arrays(2)
        with mx.cpu():
            xb, wb = mx.nd.array(x), mx.nd.array(w)
            wb.attach_grad()
            with mx.autograd.record():
                loss = (mx.nd.dot(xb, wb) ** 2).sum()
            loss.backward()
            np.testing.assert_allclose(wb.grad.asnumpy(),
                                       _grad_of_sum_of_squares(x, w),
                                       rtol=1e-5, atol=1e-5)
    finally:
        resume.set()
        t.join(30)
    assert not t.is_alive()
    x, w = _arrays(1)
    np.testing.assert_allclose(got["held"], _grad_of_sum_of_squares(x, w),
                               rtol=1e-5, atol=1e-5)


def test_each_threads_backward_sees_only_its_own_leaves():
    """Leaves fed on one thread are not in another thread's registry."""
    seen = {}

    def feed(name):
        x, w = _arrays(3)
        with mx.cpu():
            a = mx.nd.array(w)
            a.attach_grad()
            with mx.autograd.record():
                (mx.nd.dot(mx.nd.array(x), a) ** 2).sum()
            seen[name] = (id(a), set(mx.autograd._st().leaves.keys()), a)

    threads = [threading.Thread(target=feed, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    (ia, la, _), (ib, lb, _) = seen["a"], seen["b"]
    assert ia in la and ib in lb
    assert ia not in lb and ib not in la
