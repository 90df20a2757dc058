"""Faults F14-F18 of the port, each held against the JAX package on the
CPU (the port under ``with mx.cpu():``), or against numpy where the
JAX package gives numpy's answer or none:

- F14: ``nd.sparse.multiply`` of a row-sparse array by a dense operand
  of one row, or of none (a ``(C,)`` vector, against numpy);
- F15: ``mx.np`` reductions with ``initial=``, an explicit ``dtype`` (the
  accumulation and the result type) and ``where=`` (against numpy);
- F16: ``np.sort``, ``np.argsort`` and ``np.concatenate`` with
  ``axis=None``;
- F17: ``np.pad`` in every mode ``jnp.pad`` takes, and ``np.expand_dims``
  with a tuple of axes;
- F18: a block's parameter attribute (``net.weight``) as the handle:
  ``grad_req``, ``lr_mult`` and ``wd_mult`` written through it reach
  ``gluon.Trainer`` steps, and its ``name`` and methods are the
  handle's.

Inputs are made by numpy from a seed.  Tolerances: exact where both
sides make the same f32 operations on the same values (gathers,
products of two numbers, sorts, index pads, integer sums that wrap);
rtol 1e-6 / atol 1e-6 where f32 sums run in another order (float
reductions, the statistics and ramps of ``pad``).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-6, atol=1e-6)
X = np.random.RandomState(0).randn(3, 4).astype(np.float32)
A = np.array([[0, 1, 0], [2, 0, 3], [0, 0, 0], [4, 5, 0]], np.float32)


def _both(fn):
    """``fn(mx)`` in the JAX package, then in the port, each on its CPU."""
    out = []
    for mx in (jmx, tmx):
        with mx.cpu():
            out.append(fn(mx))
    return out


# -- F14: nd.sparse.multiply by a broadcasting dense operand -----------------


@pytest.mark.parametrize("dense", [A, np.random.RandomState(1).randn(
    5, 4).astype(np.float32)], ids=["4x3", "5x4"])
def test_row_sparse_times_one_row_matches_jax(dense):
    """A row-sparse array times a (1, C) array keeps its pattern and is
    the broadcast product (exact: one f32 product an element)."""
    row = np.random.RandomState(2).randn(1, dense.shape[1]).astype(
        np.float32)

    def fn(mx):
        out = mx.nd.sparse.multiply(mx.nd.array(dense).tostype("row_sparse"),
                                    mx.nd.array(row))
        return out.stype, out.asnumpy()

    (js, jv), (ts, tv) = _both(fn)
    assert ts == js == "row_sparse"
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, dense * row)


def test_row_sparse_times_a_vector_matches_numpy():
    """A (C,) operand broadcasts over the stored rows, as numpy's
    product does (the JAX package is wrong there, R19; exact)."""
    vec = np.array([1.5, -2.0, 3.0], np.float32)
    with tmx.cpu():
        out = tmx.nd.sparse.multiply(tmx.nd.array(A).tostype("row_sparse"),
                                     tmx.nd.array(vec))
        assert out.stype == "row_sparse"
        np.testing.assert_array_equal(out.asnumpy(), A * vec)


def test_row_sparse_times_a_full_operand_still_gathers_as_jax():
    """An (N, C) operand is gathered by the stored rows (exact)."""
    full = np.random.RandomState(3).randn(*A.shape).astype(np.float32)

    def fn(mx):
        return mx.nd.sparse.multiply(mx.nd.array(A).tostype("row_sparse"),
                                     mx.nd.array(full)).asnumpy()

    j, t = _both(fn)
    np.testing.assert_array_equal(t, j)


# -- F15: initial=, dtype= and where= of the np reductions -------------------


@pytest.mark.parametrize("name,kw", [
    ("sum", dict(axis=0, initial=10.0)), ("prod", dict(initial=2.0)),
    ("min", dict(axis=1, initial=-0.5)), ("max", dict(axis=0, initial=0.5)),
    ("nansum", dict(axis=1, initial=3.0)), ("sum", dict(initial=-1.0))])
def test_reduction_initial_matches_jax(name, kw):
    """``initial`` starts the reduction, as in jnp and numpy (rtol 1e-6:
    f32 sums in another order)."""
    j, t = _both(lambda mx: getattr(mx.np, name)(mx.np.array(X),
                                                 **kw).asnumpy())
    assert t.dtype == j.dtype
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(t, getattr(np, name)(X, **kw), **TOL)


@pytest.mark.parametrize("name,values,dtype", [
    ("sum", [100, 100], "int8"), ("sum", [100, 100, 100], "int16"),
    ("prod", [16, 16, 3], "int8"), ("sum", [1.5, 2.25], "float16")])
def test_reduction_dtype_is_the_accumulation_type_as_jax(name, values,
                                                          dtype):
    """An explicit ``dtype`` is the accumulation and the result type: an
    int8 sum of [100, 100] wraps to -56 as int8 (exact)."""
    src = np.array(values, dtype="int8" if "int" in dtype else "float32")

    def fn(mx):
        out = getattr(mx.np, name)(mx.np.array(src), dtype=dtype)
        return np.asarray(out.asnumpy())

    jv, tv = _both(fn)
    assert tv.dtype == jv.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, getattr(np, name)(src, dtype=dtype))


@pytest.mark.parametrize("name,kw", [
    ("sum", {}), ("sum", dict(axis=0)), ("prod", dict(axis=1)),
    ("mean", dict(axis=0)), ("max", dict(axis=1, initial=-5.0)),
    ("min", dict(initial=5.0)), ("nansum", dict(axis=1)),
    ("all", dict(axis=0)), ("any", dict(axis=1))])
def test_reduction_where_matches_numpy(name, kw):
    """``where`` masks elements out as numpy does (the JAX package raises
    on an array mask; rtol 1e-6)."""
    src = X > -1 if name in ("all", "any") else X
    mask = X > 0
    with tmx.cpu():
        got = getattr(tmx.np, name)(tmx.np.array(src),
                                    where=tmx.np.array(mask), **kw)
        np.testing.assert_allclose(got.asnumpy(),
                                   getattr(np, name)(src, where=mask, **kw),
                                   **TOL)


def test_reduction_refuses_what_it_cannot_apply():
    """A keyword a reduction does not take raises ``TypeError`` (never
    swallowed); a max over a slice that ``where`` masks out entirely
    needs ``initial``, as in numpy."""
    with tmx.cpu():
        x = tmx.np.array(X)
        with pytest.raises(TypeError):
            tmx.np.sum(x, out_dtype="int8")
        with pytest.raises(TypeError):
            tmx.np.mean(x, initial=1.0)
        with pytest.raises(ValueError):
            tmx.np.max(x, axis=0, where=tmx.np.array(X > 10))
    with pytest.raises(ValueError):
        np.max(X, axis=0, where=X > 10)


# -- F16: axis=None ----------------------------------------------------------


@pytest.mark.parametrize("name", ["sort", "argsort"])
def test_sort_and_argsort_of_the_flattened_array_as_jax(name):
    """``axis=None`` sorts the flattened array (exact)."""
    j, t = _both(lambda mx: getattr(mx.np, name)(mx.np.array(X),
                                                 axis=None).asnumpy())
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, getattr(np, name)(X, axis=None))


def test_concatenate_with_axis_none_flattens_as_jax():
    """A (3, 4) and a (4, 5) array with ``axis=None`` give their 32 values
    flat (exact)."""
    other = np.random.RandomState(4).randn(4, 5).astype(np.float32)
    j, t = _both(lambda mx: mx.np.concatenate(
        [mx.np.array(X), mx.np.array(other)], axis=None).asnumpy())
    assert t.shape == (32,)
    np.testing.assert_array_equal(t, j)


# -- F17: np.pad's modes and expand_dims with a tuple ------------------------


@pytest.mark.parametrize("src", [X, np.random.RandomState(5).randint(
    -9, 9, (3, 4)).astype(np.int32)], ids=["float32", "int32"])
@pytest.mark.parametrize("width", [2, ((1, 2), (3, 0)), ((5, 6), (7, 1))],
                         ids=["2", "1-2_3-0", "5-6_7-1"])
@pytest.mark.parametrize("mode", ["constant", "edge", "linear_ramp",
                                  "maximum", "mean", "median", "minimum",
                                  "reflect", "symmetric", "wrap", "empty"])
def test_pad_modes_match_jax(mode, width, src):
    """Every mode of ``jnp.pad``, widths past the axis' own length
    included, in the JAX package's dtype (index modes exact; statistics
    and ramps within rtol 1e-6)."""
    j, t = _both(lambda mx: mx.np.pad(mx.np.array(src), width,
                                      mode=mode).asnumpy())
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_allclose(t, j, **TOL)
    if mode != "empty":
        np.testing.assert_allclose(t, np.pad(src, width, mode=mode), **TOL)


def test_pad_op_keeps_its_three_modes():
    """The registered ``pad`` op takes constant, edge and reflect only, as
    the JAX package's op does."""
    with tmx.cpu():
        with pytest.raises(ValueError):
            tmx.nd.pad(tmx.nd.array(X.reshape(1, 1, 3, 4)), mode="wrap",
                       pad_width=(0, 0, 0, 0, 1, 1, 1, 1))


@pytest.mark.parametrize("axis", [(0, 2), (-1, 0), (1, 3, 0), 1])
def test_expand_dims_with_a_tuple_matches_jax(axis):
    j, t = _both(lambda mx: mx.np.expand_dims(mx.np.array(X),
                                              axis).asnumpy())
    assert t.shape == j.shape == np.expand_dims(X, axis).shape
    np.testing.assert_array_equal(t, j)


# -- F18: the parameter attribute as the handle ------------------------------


def _probe(mx, attr, value, sparse, steps):
    """``ROADMAP.md``'s probe: a write to ``attr`` through the block's
    attribute, then SGD (lr 0.1, wd 0.1) over ``sum(net(x))``: a Trainer
    step, or, with ``grad_req="add"``, ``steps`` backwards and the
    gradient's sum after each.  ``sparse``: an ``Embedding(sparse_grad=
    True)`` ahead of a ``Dense`` (the probed weight is the table)."""
    if sparse:
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Embedding(5, 3, sparse_grad=True),
                mx.gluon.nn.Dense(2, flatten=False))
        x = mx.nd.array(np.array([[0, 1, 1, 3]], np.float32))
    else:
        net = mx.gluon.nn.Dense(3, in_units=4)
        x = mx.nd.ones((2, 4))
    net.initialize(mx.init.One())
    layer = net[0] if sparse else net
    setattr(layer.weight, attr, value)
    assert getattr(layer.weight, attr) == value
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "wd": 0.1})
    sums = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        if value == "add":
            sums.append(float(layer.weight.grad().asnumpy().sum()))
        else:
            trainer.step(1)
    return layer.weight.data().asnumpy(), sums


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("attr,value,steps", [
    ("grad_req", "null", 1), ("lr_mult", 0, 1), ("wd_mult", 0, 1),
    ("grad_req", "add", 3)])
def test_parameter_attribute_writes_reach_the_trainer_as_jax(attr, value,
                                                             steps, sparse):
    """``grad_req="null"`` and ``lr_mult=0`` leave the weight at 1.0,
    ``wd_mult=0`` gives 0.80 (dense), ``grad_req="add"`` sums the
    gradients to 24, 48 and 72 over three backwards; the same through
    an ``Embedding(sparse_grad=True)`` table (exact: the same f32
    steps)."""
    (jw, js), (tw, ts) = _both(lambda mx: _probe(mx, attr, value, sparse,
                                                 steps))
    np.testing.assert_array_equal(tw, jw)
    assert ts == js
    if value == "add":
        assert ts == [24.0, 48.0, 72.0]
    elif not sparse:
        np.testing.assert_allclose(tw, 0.8 if attr == "wd_mult" else 1.0,
                                   rtol=1e-6)


def test_parameter_attribute_has_the_handles_name_and_methods():
    """``name``, ``list_data()``, ``list_grad()``, ``list_ctx()``,
    ``zero_grad()``, ``initialize()``, ``cast()`` and ``reset_ctx()``
    through the block's attribute, as through the JAX package's
    Parameter (exact)."""
    def fn(mx):
        net = mx.gluon.nn.Dense(3, in_units=4, prefix="probe_")
        net.initialize(mx.init.One())
        w = net.weight
        with mx.autograd.record():
            loss = net(mx.nd.ones((2, 4))).sum()
        loss.backward()
        before = w.list_grad()[0].asnumpy().copy()
        w.zero_grad()
        after = w.grad().asnumpy()
        w.initialize(mx.init.Constant(2.0), force_reinit=True)
        data = w.list_data()[0].asnumpy()
        ctx = [str(c) for c in w.list_ctx()]
        w.reset_ctx(mx.cpu())
        w.cast("float16")
        return (w.name, before, after, data, ctx,
                str(net.collect_params()["probe_weight"].dtype))

    j, t = _both(fn)
    assert t[0] == j[0] == "probe_weight"
    for a, b in zip(t[1:4], j[1:4]):
        np.testing.assert_array_equal(a, b)
    assert t[4] == j[4]
    assert t[5] == j[5] == "float16"
