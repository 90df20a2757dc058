"""The port's control flow (``nd.contrib.foreach``, ``while_loop``,
``cond`` and the registered ``_foreach``, ``_while_loop``, ``_cond``)
against the JAX package's, on the CPU.

The bodies are the same Python functions over each package's NDArrays,
on the same seeded inputs.  Outside ``record()``: the outputs (a
``while_loop``'s padded to ``max_iterations`` rows) and final states
within rtol 1e-6; inside ``record()``: the trimmed outputs and the
gradients of the inputs and of an array the body closes over, within
rtol 1e-5 / atol 1e-6.  The refusal of a host read under a CUDA graph
capture is a card test (``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-6)


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


def _both(fn, record=False, arrays=()):
    """``fn(mx, *NDArrays)`` in both packages (the port's on the host);
    with ``record`` also the gradients of the arrays.  Returns
    ``[(outputs, grads)]`` as numpy, JAX first."""
    res = []
    for mx in (jmx, tmx):
        ctx = mx.cpu()
        with ctx:
            nds = [mx.nd.array(a, ctx=ctx) for a in arrays]
            if record:
                for x in nds:
                    x.attach_grad()
                with mx.autograd.record():
                    outs = fn(mx, *nds)
                    flat = _flat(outs)
                    head = sum((o * (i + 1.5)).sum() for i, o in
                               enumerate(flat))
                head.backward()
                grads = [x.grad.asnumpy() for x in nds]
            else:
                outs = fn(mx, *nds)
                flat = _flat(outs)
                grads = []
        res.append(([o.asnumpy() for o in flat], grads))
    return res


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


def _close(pair, tol=TOL):
    (jo, jg), (to, tg) = pair
    assert len(jo) == len(to) and len(jg) == len(tg)
    for a, b in zip(to + tg, jo + jg):
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_allclose(a, b, **tol)


# -- foreach --------------------------------------------------------------------------


def _scan_body(mx, w):
    def body(x, states):
        h = states[0]
        new = mx.nd.tanh(x * w + h)
        return [new * 2, x.sum()], [new]
    return body


@pytest.mark.parametrize("record", [False, True])
def test_foreach_matches_jax(record):
    data, h0, w = _f32(5, 3), _f32(3, seed=1), _f32(3, seed=2)

    def fn(mx, d, h, wt):
        outs, states = mx.nd.contrib.foreach(_scan_body(mx, wt), d, [h])
        return [outs, states]

    _close(_both(fn, record, [data, h0, w]))


def test_foreach_single_array_in_gives_single_array_out():
    def fn(mx, d, s):
        out, st = mx.nd.contrib.foreach(lambda x, s: (x + s, s * 2), d, s)
        assert not isinstance(out, (list, tuple))
        assert not isinstance(st, (list, tuple))
        return [out, st]

    _close(_both(fn, False, [_f32(4, 2), _f32(2, seed=1)]))


# -- while_loop ---------------------------------------------------------------------------


def _loop(mx, scale):
    def cond(i, s):
        return i < 4

    def func(i, s):
        return [s * scale, i], [i + 1, s * scale + 1]

    return cond, func


@pytest.mark.parametrize("record", [False, True])
def test_while_loop_matches_jax(record):
    """Outside record(): 7 rows, the last 3 zero (padded); inside: 4."""
    i0, s0, scale = np.zeros(1, np.float32), _f32(3), _f32(3, seed=1)

    def fn(mx, i, s, sc):
        cond, func = _loop(mx, sc)
        outs, final = mx.nd.contrib.while_loop(cond, func, [i, s],
                                               max_iterations=7)
        return [outs, final]

    pair = _both(fn, record, [i0, s0, scale])
    _close(pair)
    rows = pair[1][0][0].shape[0]
    assert rows == (4 if record else 7)
    if not record:
        assert not pair[1][0][0][4:].any()


def test_while_loop_stops_at_max_iterations_and_needs_it():
    def fn(mx, i):
        outs, final = mx.nd.contrib.while_loop(
            lambda i: i < 100, lambda i: ([i * 2], [i + 1]), [i],
            max_iterations=3)
        return [outs, final]

    pair = _both(fn, False, [np.zeros(1, np.float32)])
    _close(pair)
    np.testing.assert_array_equal(pair[1][0][1], [3.0])
    with tmx.cpu(), pytest.raises(MXNetError, match="max_iterations"):
        tmx.nd.contrib.while_loop(lambda i: i < 1, lambda i: ([i], [i]),
                                  [tmx.nd.zeros((1,))])


# -- cond ---------------------------------------------------------------------------------


@pytest.mark.parametrize("flag", [0.0, 1.0])
@pytest.mark.parametrize("record", [False, True])
def test_cond_runs_the_taken_branch_as_jax(flag, record):
    def fn(mx, p, x, y):
        return mx.nd.contrib.cond(p, lambda: [x * y, x + 1],
                                  lambda: [x - y, y * 3])

    _close(_both(fn, record, [np.array([flag], np.float32), _f32(4),
                              _f32(4, seed=1)]))


# -- the registered ops ----------------------------------------------------------------


def test_registered_control_flow_ops_match_jax():
    def fn(mx, d, h, i):
        f_out = mx.nd._foreach(d, h, body=lambda x, s: (x * s, s + x),
                               num_data=1)
        w_out = mx.nd._while_loop(
            i, cond=lambda i: i < 2, func=lambda i: ([i * 10], [i + 1]),
            max_iterations=4)
        c_out = mx.nd._cond(i, d, cond=lambda i, d: i < 1,
                            then_func=lambda i, d: d * 2,
                            else_func=lambda i, d: d * 3)
        return [list(f_out), list(w_out), c_out]

    _close(_both(fn, False, [_f32(3, 2), _f32(2, seed=1),
                             np.zeros(1, np.float32)]))
    with tmx.cpu(), pytest.raises(MXNetError, match="body"):
        tmx.nd._foreach(tmx.nd.zeros((2, 2)), tmx.nd.zeros((2,)))
