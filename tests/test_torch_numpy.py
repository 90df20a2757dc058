"""The port's ``mx.np``/``mx.npx`` frontend against the JAX package's, on
the CPU.

The cases of ``tests/test_numpy.py`` (its lists copied in: the interop
sweep, the statistics wave, the linalg, extras and window lists,
histogram/digitize, the protocols, zero-dim/zero-size, bool comparisons
and masking, true division, the flags, ``as_nd_ndarray``) run through
both packages on the same numpy-seeded inputs.  Each f32 output must
agree within 1e-6 of its largest magnitude (``_close``), unless a case
states otherwise; its shape must agree, and so must its dtype, but where
a 64-bit input stays 64-bit in the port (the JAX package narrows it).
The factorizations whose signs are free (``svd``, ``eigh``, ``qr``) are
held by reconstruction and by their factors' absolute values.
``np.random`` is held by moments and KS, never by value.

Then the class machinery (an op's results take the class of its first
input) on every route: eager ``registry.invoke``, a deferred bulk op,
``invoke_fn``, the host-read overrides, a Gluon block's outputs,
``hybrid_forward`` and a hybridized call; R13 and R14 as the port
behaves; and the numpy-mode BERT script at ``bert_small``, eager and
hybridized, against the JAX package's with the weights carried by
``bert.load_jax_params``.
"""
import numpy as onp
import pytest
import scipy.stats
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, engine, gluon
from mxnet_tpu_torch.gluon.model_zoo import bert
from mxnet_tpu_torch.ops import registry

jnp_ = jmx.np
np = tmx.np


@pytest.fixture(autouse=True)
def host():
    with tmx.cpu():
        yield
    tmx.reset_np()
    jmx.reset_np()


def _close(got, want, rel=1e-6, what=""):
    """Equal within ``rel`` of ``want``'s largest magnitude (NaNs in the
    same places)."""
    got, want = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert onp.array_equal(onp.isnan(got), onp.isnan(want)), what
    got, want = onp.nan_to_num(got), onp.nan_to_num(want)
    scale = max(onp.abs(want).max(initial=0.0), 1e-30)
    err = onp.abs(got - want).max(initial=0.0) / scale
    assert err <= rel, "%s: error %.3g of the largest value (%.3g) > %.3g" \
        % (what, err, scale, rel)


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _wide(args):
    """Whether a 64-bit numpy array is among ``args``."""
    flat = []
    for a in args:
        flat += a if isinstance(a, list) else [a]
    return any(isinstance(a, onp.ndarray) and a.dtype in (onp.int64,
                                                          onp.float64)
               for a in flat)


def _both(name, args, rel=1e-6, conv=None, ns=lambda m: m.np):
    """``name`` of ``mx.np`` (``ns`` picks a submodule) in both packages
    on ``args`` (numpy arrays become arrays of each package by ``conv``),
    held output by output."""
    conv = conv or (lambda mx, x: mx.np.array(x)
                    if isinstance(x, onp.ndarray) and x.dtype != onp.int64
                    else [mx.np.array(i) for i in x]
                    if isinstance(x, list) else x)
    want = _outs(getattr(ns(jmx), name)(*[conv(jmx, a) for a in args]))
    got = _outs(getattr(ns(tmx), name)(*[conv(tmx, a) for a in args]))
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray), (name, type(g))
        if not _wide(args):
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        _close(g.asnumpy(), w.asnumpy(), rel, name)


# ---------------------------------------------------------------------------
# tests/test_numpy.py's lists, through both packages
# ---------------------------------------------------------------------------
_A = onp.arange(12, dtype=onp.float32).reshape(3, 4) / 7 + 0.3
_B = onp.arange(12, dtype=onp.float32).reshape(3, 4)[::-1].copy() / 5 + 0.1
_SQ = onp.array([[2.0, 0.5], [0.5, 1.0]], onp.float32)
_V = onp.linspace(0.2, 0.9, 5).astype(onp.float32)

_INTEROP = [
    ("add", (_A, _B)),
    ("subtract", (_A, _B)),
    ("multiply", (_A, _B)),
    ("divide", (_A, _B)),
    ("power", (_A, 2.0)),
    ("maximum", (_A, _B)),
    ("minimum", (_A, _B)),
    ("mod", (_A, _B)),
    ("hypot", (_A, _B)),
    ("arctan2", (_A, _B)),
    ("logaddexp", (_A, _B)),
    ("copysign", (_A, -_B)),
    ("exp", (_A,)),
    ("expm1", (_A,)),
    ("log", (_A,)),
    ("log2", (_A,)),
    ("log10", (_A,)),
    ("log1p", (_A,)),
    ("sqrt", (_A,)),
    ("cbrt", (_A,)),
    ("square", (_A,)),
    ("reciprocal", (_A,)),
    ("sin", (_A,)),
    ("cos", (_A,)),
    ("tan", (_V,)),
    ("arcsin", (_V,)),
    ("arccos", (_V,)),
    ("arctan", (_A,)),
    ("sinh", (_V,)),
    ("cosh", (_V,)),
    ("tanh", (_A,)),
    ("arcsinh", (_A,)),
    ("arctanh", (_V,)),
    ("degrees", (_A,)),
    ("radians", (_A,)),
    ("floor", (_A,)),
    ("ceil", (_A,)),
    ("trunc", (_A,)),
    ("rint", (_A,)),
    ("absolute", (-_A,)),
    ("sign", (_A - 1.0,)),
    ("sum", (_A,)),
    ("mean", (_A,)),
    ("std", (_A,)),
    ("var", (_A,)),
    ("prod", (_V,)),
    ("max", (_A,)),
    ("min", (_A,)),
    ("argmax", (_A,)),
    ("argmin", (_A,)),
    ("cumsum", (_A,)),
    ("argsort", (_B,)),
    ("sort", (_B,)),
    ("median", (_A,)),
    ("transpose", (_A,)),
    ("reshape", (_A, (4, 3))),
    ("swapaxes", (_A, 0, 1)),
    ("expand_dims", (_A, 1)),
    ("squeeze", (_A[None],)),
    ("broadcast_to", (_V, (3, 5))),
    ("tile", (_A, (2, 1))),
    ("repeat", (_A, 2, 1)),
    ("flip", (_A, 0)),
    ("roll", (_A, 1, 0)),
    ("rot90", (_A,)),
    ("concatenate", ([_A, _B],)),
    ("stack", ([_A, _B],)),
    ("vstack", ([_A, _B],)),
    ("hstack", ([_A, _B],)),
    ("split", (_A, 2, 1)),
    ("diag", (_V,)),
    ("tril", (_A,)),
    ("triu", (_A,)),
    ("dot", (_A, _B.T)),
    ("matmul", (_A, _B.T)),
    ("inner", (_V, _V)),
    ("outer", (_V, _V)),
    ("tensordot", (_A, _B.T, 1)),
    ("kron", (_SQ, _SQ)),
    ("trace", (_A,)),
    ("where", (_A > 0.8, _A, _B)),
    ("isnan", (_A,)),
    ("isinf", (_A,)),
    ("isfinite", (_A,)),
    ("clip", (_A, 0.4, 1.2)),
    ("round", (_A,)),
    ("take", (_V, onp.array([0, 2], onp.int64),)),
    ("zeros_like", (_A,)),
    ("ones_like", (_A,)),
    ("unique", (onp.array([1.0, 2.0, 1.0, 3.0], onp.float32),)),
    ("atleast_1d", (_V,)),
    ("nansum", (_A,)),
    ("logical_and", (_A > 0.5, _B > 0.5)),
    ("logical_or", (_A > 0.5, _B > 0.5)),
    ("logical_xor", (_A > 0.5, _B > 0.5)),
    ("logical_not", (_A > 0.5,)),
    ("average", (_A,)),
    ("einsum", ("ij,ij->i", _A, _B)),
    ("pad", (_SQ, ((1, 1), (0, 2)))),
    ("moveaxis", (_A[None], 0, 2)),
]
# the transcendental functions of XLA's CPU backend and of torch's round
# differently: within 2e-6 of the largest value (a few f32 ulps)
_ULPS = {"expm1", "arcsinh", "arctanh", "logaddexp", "cbrt", "tan",
         "hypot", "arctan2", "cosh", "sinh", "log10", "log1p", "exp",
         "log2", "arccos", "arcsin", "std", "var", "median", "prod"}


@pytest.mark.parametrize("name,args", _INTEROP,
                         ids=[n for n, _ in _INTEROP])
def test_interop_matches_jax(name, args):
    _both(name, args, rel=2e-6 if name in _ULPS else 1e-6)


_NAN = onp.array([[1.0, onp.nan, 3.0], [4.0, 5.0, onp.nan]], onp.float32)

_STATS_WAVE = [
    ("percentile", (_A, 30.0)),
    ("quantile", (_A, 0.3)),
    ("ptp", (_A,)),
    ("nanmean", (_NAN,)),
    ("nanstd", (_NAN,)),
    ("nanvar", (_NAN,)),
    ("nanmax", (_NAN,)),
    ("nanmin", (_NAN,)),
    ("nanargmax", (_NAN,)),
    ("nanargmin", (_NAN,)),
    ("corrcoef", (_A,)),
    ("cov", (_A,)),
    ("polyval", (onp.array([1.0, -2.0, 1.0], onp.float32), _V)),
    ("ediff1d", (_V,)),
    ("nan_to_num", (_NAN,)),
    ("trapz", (_V,)),
    ("isin", (_A, onp.array([0.3, 1.0], onp.float32))),
    ("intersect1d", (onp.array([1.0, 2.0, 5.0], onp.float32),
                     onp.array([2.0, 5.0, 7.0], onp.float32))),
    ("union1d", (onp.array([1.0, 2.0], onp.float32),
                 onp.array([2.0, 3.0], onp.float32))),
    ("setdiff1d", (onp.array([1.0, 2.0, 5.0], onp.float32),
                   onp.array([2.0], onp.float32))),
    ("setxor1d", (onp.array([1.0, 2.0, 5.0], onp.float32),
                  onp.array([2.0, 7.0], onp.float32))),
    ("fmod", (_A, _B)),
    ("gcd", (onp.array([12, 18]), onp.array([8, 12]))),
    ("heaviside", (_A - 1.0, onp.float32(0.5))),
    ("nextafter", (_A, _B)),
    ("deg2rad", (_A,)),
    ("rad2deg", (_A,)),
    ("signbit", (_A - 1.0,)),
]
_STATS_TOL = {"corrcoef": 1e-5, "cov": 1e-5, "nanstd": 2e-6,
              "nanvar": 2e-6}


@pytest.mark.parametrize("name,args", _STATS_WAVE,
                         ids=[n for n, _ in _STATS_WAVE])
def test_stats_wave_matches_jax(name, args):
    """corrcoef and cov within 1e-5 (a mean, then a product over the
    centred rows: XLA and torch sum in other orders)."""
    conv = (lambda mx, x: mx.np.array(x) if isinstance(x, onp.ndarray)
            else x)
    _both(name, args, rel=_STATS_TOL.get(name, 1e-6), conv=conv)


_LINALG = [
    ("norm", (_A,)),
    ("inv", (_SQ,)),
    ("det", (_SQ,)),
    ("cholesky", (_SQ,)),
    ("eigvalsh", (_SQ,)),
    ("solve", (_SQ, onp.array([1.0, 2.0], onp.float32))),
    ("pinv", (onp.random.RandomState(3).randn(3, 4).astype(onp.float32),)),
    ("matrix_rank", (_SQ,)),
    ("slogdet", (_SQ,)),
    ("tensorinv", (onp.eye(4, dtype=onp.float32).reshape(4, 2, 2) * 2,
                   1)),
    ("tensorsolve", (onp.eye(6, dtype=onp.float32).reshape(6, 2, 3) * 3,
                     onp.arange(6, dtype=onp.float32))),
    ("lstsq", (onp.random.RandomState(4).randn(5, 3).astype(onp.float32),
               onp.random.RandomState(5).randn(5).astype(onp.float32))),
]


@pytest.mark.parametrize("name,args", _LINALG, ids=[n for n, _ in _LINALG])
def test_linalg_matches_jax(name, args):
    """Within 1e-5 of each output's largest value (LAPACK's and XLA's
    factorizations round differently)."""
    _both(name, args, rel=1e-5, ns=lambda m: m.np.linalg)


@pytest.mark.parametrize("name", ["svd", "eigh", "qr"])
def test_free_sign_factorizations_match_jax(name):
    """Reconstruction within 1e-5 of the input's largest value, and each
    factor's absolute values within 1e-5 of the JAX package's (signs are
    free in LAPACK and in XLA)."""
    a = onp.random.RandomState(6).randn(4, 3).astype(onp.float32)
    if name == "eigh":
        a = (a.T @ a).astype(onp.float32)
    got = [g.asnumpy() for g in getattr(np.linalg, name)(np.array(a))]
    want = [w.asnumpy() for w in getattr(jnp_.linalg, name)(
        jnp_.array(a))]
    assert all(isinstance(g, onp.ndarray) for g in got)
    if name == "svd":
        u, s, vt = got
        rec = (u * s) @ vt
    elif name == "eigh":
        w, v = got
        rec = (v * w) @ v.T
    else:
        q, r = got
        rec = q @ r
    _close(rec, a, 1e-5, name)
    for g, w in zip(got, want):
        _close(onp.abs(g), onp.abs(w), 1e-5, name)


_EXTRAS = [
    ("searchsorted", (onp.array([1., 2., 4., 8.], onp.float32),
                      onp.array([3., 0.5], onp.float32))),
    ("bincount", (onp.array([0, 1, 1, 3], onp.int32),)),
    ("interp", (onp.array([1.5, 2.5], onp.float32),
                onp.array([1., 2., 3.], onp.float32),
                onp.array([10., 20., 30.], onp.float32))),
    ("diff", (_A,)),
    ("cross", (onp.array([1., 0., 0.], onp.float32),
               onp.array([0., 1., 0.], onp.float32))),
    ("cumprod", (_V,)),
    ("gradient", (_A,)),
]


@pytest.mark.parametrize("name,args", _EXTRAS, ids=[n for n, _ in _EXTRAS])
def test_extras_match_jax(name, args):
    _both(name, args)


@pytest.mark.parametrize("name", ["hanning", "hamming", "blackman",
                                  "bartlett"])
def test_window_functions_match_jax(name):
    """Within 1e-6 of the largest value: the port forms the window in
    f64, XLA in f32."""
    got, want = getattr(np, name)(8), getattr(jnp_, name)(8)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    _close(got.asnumpy(), want.asnumpy(), 1e-6, name)
    _close(got.asnumpy(), getattr(onp, name)(8), 1e-6, name)


def test_histogram_and_digitize_match_jax():
    data = onp.array([1.0, 2.0, 2.0, 3.0, 9.0], onp.float32)
    for kw in ({"bins": 4, "range": (0.0, 8.0)}, {"bins": 3}):
        c, e = np.histogram(np.array(data), **kw)
        jc, je = jnp_.histogram(jnp_.array(data), **kw)
        assert onp.array_equal(c.asnumpy(), jc.asnumpy())
        _close(e.asnumpy(), je.asnumpy(), 0, "edges")
    c, e = np.histogram(np.array(data), bins=[0.0, 2.0, 5.0, 9.0])
    onp.testing.assert_array_equal(
        c.asnumpy(), onp.histogram(data, bins=[0.0, 2.0, 5.0, 9.0])[0])
    x = onp.array([0.2, 6.4, 3.0, 1.6], onp.float32)
    for bins in (onp.array([0.0, 1.0, 2.5, 4.0, 10.0], onp.float32),
                 onp.array([10.0, 4.0, 2.5, 1.0, 0.0], onp.float32)):
        for right in (False, True):
            got = np.digitize(np.array(x), np.array(bins), right=right)
            want = jnp_.digitize(jnp_.array(x), jnp_.array(bins),
                                 right=right)
            assert got.dtype == want.dtype
            onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_array_function_protocol_reaches_the_port():
    """numpy's functions on ``mx.np`` arrays run the port's own (an
    ``mx.np.ndarray`` comes back, not a host copy), as in the JAX
    package."""
    for mx in (jmx, tmx):
        a = mx.np.array(_A)
        out = onp.concatenate([a, a])
        assert isinstance(out, mx.np.ndarray) and out.shape == (6, 4)
        for fn in (onp.sum, onp.mean):
            out = fn(a, axis=0)
            assert isinstance(out, mx.np.ndarray)
            _close(out.asnumpy(), fn(_A, axis=0))
        out = onp.percentile(a, 60.0)
        assert abs(float(out) - float(onp.percentile(_A, 60.0))) < 1e-4
        out = onp.nanmean(mx.np.array(_NAN))
        assert abs(float(out) - float(onp.nanmean(_NAN))) < 1e-5
        assert abs(float(onp.ptp(a)) - float(onp.ptp(_A))) < 1e-6


def test_array_ufunc_protocol_matches_jax():
    for name in ("add", "exp", "fmod", "hypot"):
        args = (_A, 1.0) if name == "add" else (_A,) if name == "exp" \
            else (_A, _B)
        got = getattr(onp, name)(*[np.array(a) if isinstance(
            a, onp.ndarray) else a for a in args])
        want = getattr(onp, name)(*[jnp_.array(a) if isinstance(
            a, onp.ndarray) else a for a in args])
        assert isinstance(got, np.ndarray), name
        _close(got.asnumpy(), want.asnumpy(), 2e-6, name)


def test_zero_dim_and_zero_size_match_jax():
    for mx in (jmx, tmx):
        z = mx.np.array(2.5)
        assert z.shape == () and z.item() == 2.5
        assert (z * 2).shape == ()
        e = mx.np.ones((0, 4))
        assert e.shape == (0, 4) and e.size == 0
        assert mx.np.sum(e).item() == 0.0
        assert mx.np.concatenate([e, mx.np.ones((2, 4))]).shape == (2, 4)
        assert mx.np.mean(mx.np.ones((2, 0)), axis=0).shape == (0,)


def test_bool_comparisons_and_masking_match_jax():
    """Comparisons give ``bool`` arrays; a boolean mask picks what the
    JAX package picks."""
    a, ja = np.array(_A), jnp_.array(_A)
    for op in ("__gt__", "__ge__", "__lt__", "__le__", "__eq__", "__ne__"):
        m, jm = getattr(a, op)(0.8), getattr(ja, op)(0.8)
        assert m.dtype == jm.dtype == onp.bool_ and isinstance(m, np.ndarray)
        onp.testing.assert_array_equal(m.asnumpy(), jm.asnumpy())
    m = a > 0.8
    onp.testing.assert_array_equal(a[m].asnumpy(), ja[ja > 0.8].asnumpy())
    assert (a == np.array(_B)).dtype == onp.bool_


def test_boolean_mask_keeps_the_np_class_r14():
    """R14: the JAX package's mask read gives a plain NDArray
    (``<NDArray 3 @cpu(0)>``); the port's stays an ``mx.np.ndarray``,
    as MXNet's and every other op here; the values agree."""
    x = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    a, ja = np.array(x), jnp_.array(x)
    got, want = a[a > 2], ja[ja > 2]
    assert type(want) is jmx.nd.NDArray
    assert type(got) is np.ndarray
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_true_division_of_ints_matches_jax():
    for op in (lambda a: a / 2, lambda a: 3 / a, lambda a: a / a,
               lambda a: a / 2.5):
        x = onp.array([1, 2, 3], onp.int32)
        got, want = op(np.array(x, dtype="int32")), op(
            jnp_.array(x, dtype="int32"))
        assert got.dtype == want.dtype == onp.float32
        _close(got.asnumpy(), want.asnumpy())


def test_set_np_flags_as_jax():
    for mx in (jmx, tmx):
        assert not mx.is_np_array()
        mx.set_np()
        assert mx.is_np_array() and mx.is_np_shape()
        assert mx.npx.is_np_array() and mx.util.is_np_shape()
        mx.reset_np()
        assert not mx.is_np_shape()
        with mx.npx.np_shape(True):
            assert mx.is_np_shape()
        assert not mx.is_np_shape()
        with pytest.raises(ValueError):
            mx.npx.set_np(shape=False, array=True)

        @mx.util.use_np
        def inside():
            return mx.is_np_array()

        assert inside() and not mx.is_np_array()


def test_util_names_as_jax(tmp_path):
    for name in ("use_np_shape", "use_np_array", "makedirs", "set_module",
                 "wraps_safely", "get_gpu_count", "get_accelerator_count"):
        assert callable(getattr(tmx.util, name)), name
    tmx.util.makedirs(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
    assert tmx.util.get_gpu_count() == torch.cuda.device_count()
    assert tmx.util.get_accelerator_count() == torch.cuda.device_count()


def test_as_nd_ndarray_roundtrip_as_jax():
    a = np.array(_A)
    view = a.as_nd_ndarray()
    assert type(view) is tmx.nd.NDArray
    assert view.data() is a.data()
    again = np.array(view)
    assert isinstance(again, np.ndarray)
    nd = tmx.nd.array(_A)
    assert nd.as_nd_ndarray() is nd
    assert not hasattr(tmx.nd.NDArray, "as_np_ndarray")
    assert a.as_np_ndarray() is a


def test_autograd_matches_jax():
    xv = onp.array([0.5, 1.0, 2.0], onp.float32)
    grads = []
    for mx in (jmx, tmx):
        x = mx.np.array(xv)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.np.sum(x ** 2 * mx.np.exp(x))
        y.backward()
        assert isinstance(x.grad, mx.nd.NDArray)
        grads.append(x.grad.asnumpy())
    _close(grads[1], grads[0], 1e-6)


def test_backward_through_a_float_loss_plus_an_int_term_r13():
    """R13: the JAX package's backward fails on the int term's cotangent
    cast (``ValueError: invalid literal for int()``); the port gives
    ``x.grad == 2 * x``, as MXNet does."""
    xv = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    x = np.array(xv)
    x.attach_grad()
    with autograd.record():
        loss = np.sum(x * x) + (x.argmax(axis=1) == 0).sum()
    loss.backward()
    onp.testing.assert_array_equal(x.grad.asnumpy(), 2 * xv)
    jx = jnp_.array(xv)
    jx.attach_grad()
    with jautograd.record():
        jl = jnp_.sum(jx * jx) + (jx.argmax(axis=1) == 0).sum()
    with pytest.raises(ValueError, match="invalid literal"):
        jl.backward()


def test_npx_ops_return_np_arrays_as_jax():
    x = onp.random.RandomState(0).randn(2, 8).astype(onp.float32)
    w = onp.random.RandomState(1).randn(3, 8).astype(onp.float32)
    idx = onp.array([1, 7], onp.float32)
    for name, args, kw in (
            ("softmax", (x,), {}), ("log_softmax", (x,), {}),
            ("relu", (x,), {}), ("sigmoid", (x,), {}),
            ("fully_connected", (x, w), {"num_hidden": 3,
                                         "no_bias": True}),
            ("pick", (x, idx), {}), ("topk", (x,), {"k": 2}),
            ("one_hot", (idx,), {"depth": 8}), ("erf", (x,), {}),
            ("layer_norm", (x, onp.ones(8, onp.float32),
                            onp.zeros(8, onp.float32)), {}),
            ("batch_dot", (x[None], x.T[None].copy()), {})):
        got = getattr(tmx.npx, name)(*[np.array(a) for a in args], **kw)
        want = getattr(jmx.npx, name)(*[jnp_.array(a) for a in args], **kw)
        assert isinstance(got, np.ndarray), name
        _close(got.asnumpy(), want.asnumpy(), 2e-6, name)


def test_stragglers_match_jax(tmp_path):
    """``test_numpy.py``'s round-4 stragglers through both packages."""
    a = onp.array([[1., 2.], [3., 4.]], onp.float32)
    cases = [
        ("append", (a, onp.array([[5., 6.]], onp.float32)), {"axis": 0}),
        ("around", (onp.array([1.26], onp.float32), 1), {}),
        ("ravel", (a,), {}), ("fliplr", (a,), {}), ("flipud", (a,), {}),
        ("column_stack", ((onp.array([1., 2.], onp.float32),
                           onp.array([3., 4.], onp.float32)),), {}),
        ("row_stack", ((onp.array([1., 2.], onp.float32),
                        onp.array([3., 4.], onp.float32)),), {}),
        ("hsplit", (a, 2), {}), ("vsplit", (a, 2), {}),
        ("broadcast_arrays", (onp.array([[1.], [2.]], onp.float32),
                              onp.array([3., 4.], onp.float32)), {}),
        ("vdot", (onp.array([1., 2.], onp.float32),
                  onp.array([3., 4.], onp.float32)), {}),
        ("ldexp", (onp.array([1.5], onp.float32),
                   onp.array([2], onp.int32)), {}),
        ("delete", (onp.array([1., 2., 3., 4.], onp.float32), [1]), {}),
        ("delete", (onp.array([1., 2., 3.], onp.float32),
                    onp.array([True, False, True])), {}),
        ("resize", (onp.array([1., 2.], onp.float32), (5,)), {}),
        ("unravel_index", (onp.array([5], onp.int32), (2, 3)), {}),
        ("bitwise_or", (onp.array([4], onp.int32),
                        onp.array([1], onp.int32)), {}),
        ("bitwise_xor", (onp.array([5], onp.int32),
                         onp.array([1], onp.int32)), {}),
        ("invert", (onp.array([0], onp.int32),), {}),
        ("empty_like", (a,), {}),
        ("array_split", (onp.arange(5, dtype=onp.float32), 3), {}),
    ]
    for name, args, kw in cases:
        def run(mx):
            conv = [mx.np.array(x) if isinstance(x, onp.ndarray)
                    and x.dtype != onp.bool_ else
                    tuple(mx.np.array(i) for i in x)
                    if isinstance(x, tuple) and isinstance(
                        x[0], onp.ndarray) else x for x in args]
            return _outs(getattr(mx.np, name)(*conv, **kw))
        got, want = run(tmx), run(jmx)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray), name
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            _close(g.asnumpy(), w.asnumpy(), 1e-6, name)
    assert np.indices((2, 2)).shape == jnp_.indices((2, 2)).shape
    assert np.shares_memory(np.array(a), np.array(a)) is False
    b = np.array(a)
    assert np.shares_memory(b, b) and np.may_share_memory(b, b)
    with pytest.raises(TypeError):
        np.bitwise_or(np.array([1.5]), np.array([2.5]))
    path = tmp_path / "t.csv"
    path.write_text("1,2\n3,4\n")
    assert np.genfromtxt(str(path), delimiter=",").shape == (2, 2)
    buf = np.zeros((1,))
    ret = np.around(np.array([1.26]), 1, out=buf)
    assert ret is buf and abs(float(buf.asnumpy()[0]) - 1.3) < 1e-6
    saved = onp.get_printoptions()
    try:
        np.set_printoptions(precision=3)
        assert onp.get_printoptions()["precision"] == 3
    finally:
        onp.set_printoptions(**saved)


@pytest.mark.parametrize("case", ["float_sum", "int_sum", "arange",
                                  "bool_mean", "array_float64",
                                  "array_int64", "list_int", "full_int"])
def test_dtypes_follow_jax_but_64_bit_arrays_stay_64_bit(case):
    """Floats are float32, ``arange(5)`` float32, an int sum int32, as in
    the JAX package; a 64-bit numpy array keeps its type in the port."""
    def run(mx):
        return {
            "float_sum": lambda: mx.np.sum(mx.np.array([1.5, 2.0])),
            "int_sum": lambda: mx.np.sum(mx.np.array([1, 2], dtype="int32")),
            "arange": lambda: mx.np.arange(5),
            "bool_mean": lambda: mx.np.mean(mx.np.array([1.0, 3.0]) > 2),
            "array_float64": lambda: mx.np.array(onp.ones(2)),
            "array_int64": lambda: mx.np.array(onp.arange(2)),
            "list_int": lambda: mx.np.array([1, 2]),
            "full_int": lambda: mx.np.full((2,), 3),
        }[case]()
    got, want = run(tmx), run(jmx)
    if case == "array_float64":
        assert want.dtype == onp.float32 and got.dtype == onp.float64
    elif case == "array_int64":
        assert want.dtype == onp.int32 and got.dtype == onp.int64
    else:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_npi_ops_are_in_mx_nd_as_in_jax():
    out = tmx.nd._npi_percentile(tmx.nd.array(_A), q=40.0)
    want = jmx.nd._npi_percentile(jmx.nd.array(_A), q=40.0)
    _close(out.asnumpy(), want.asnumpy())
    c, e = tmx.nd._npi_histogram(tmx.nd.array(_V), bin_cnt=3,
                                 range=(0.0, 1.0))
    jc, je = jmx.nd._npi_histogram(jmx.nd.array(_V), bin_cnt=3,
                                   range=(0.0, 1.0))
    onp.testing.assert_array_equal(c.asnumpy(), jc.asnumpy())
    _close(tmx.nd._npi_hanning(M=6).asnumpy(),
           jmx.nd._npi_hanning(M=6).asnumpy())


# ---------------------------------------------------------------------------
# np.random: moments and KS
# ---------------------------------------------------------------------------

_N = 200_000


def _moments_ok(x, mean, var, what):
    """Mean and variance each within 5 standard errors (the variance's
    from the sample's fourth central moment)."""
    x = onp.asarray(x, onp.float64).ravel()
    se_mean = (var / x.size) ** 0.5
    m4 = ((x - x.mean()) ** 4).mean()
    se_var = ((m4 - x.var() ** 2) / x.size) ** 0.5
    assert abs(x.mean() - mean) < 5 * se_mean + 1e-12, (what, x.mean(),
                                                         mean)
    assert abs(x.var() - var) < 5 * se_var + 1e-12, (what, x.var(), var)


@pytest.mark.parametrize("name", ["uniform", "normal", "randint",
                                  "exponential", "gamma", "beta",
                                  "poisson", "choice", "rand", "randn"])
def test_np_random_by_moments(name):
    """Mean and variance within 5 standard errors of the distribution's;
    the continuous ones also pass KS at alpha 1e-6; the shape and dtype
    are the JAX package's."""
    tmx.random.seed(3)
    jmx.random.seed(3)
    calls = {
        "uniform": (lambda r: r.uniform(-1.0, 3.0, size=(_N,)),
                    (1.0, 16 / 12), ("uniform", (-1.0, 4.0))),
        "normal": (lambda r: r.normal(1.0, 2.0, size=(_N,)),
                   (1.0, 4.0), ("norm", (1.0, 2.0))),
        "randint": (lambda r: r.randint(0, 10, size=(_N,)),
                    (4.5, 99 / 12), None),
        "exponential": (lambda r: r.exponential(2.0, size=(_N,)),
                        (2.0, 4.0), ("expon", (0.0, 2.0))),
        "gamma": (lambda r: r.gamma(3.0, 2.0, size=(_N,)),
                  (6.0, 12.0), ("gamma", (3.0, 0.0, 2.0))),
        "beta": (lambda r: r.beta(2.0, 3.0, size=(_N,)),
                 (0.4, 6 / 150), ("beta", (2.0, 3.0))),
        "poisson": (lambda r: r.poisson(3.0, size=(_N,)), (3.0, 3.0), None),
        "choice": (lambda r: r.choice(5, size=(_N,)), (2.0, 2.0), None),
        "rand": (lambda r: r.rand(_N), (0.5, 1 / 12), ("uniform", (0, 1))),
        "randn": (lambda r: r.randn(_N), (0.0, 1.0), ("norm", (0, 1))),
    }
    draw, (mean, var), ks = calls[name]
    got, want = draw(np.random), draw(jnp_.random)
    assert isinstance(got, np.ndarray)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.dtype, want.dtype)
    _moments_ok(got.asnumpy(), mean, var, name)
    if ks is not None:
        stat = scipy.stats.kstest(got.asnumpy().astype(onp.float64), ks[0],
                                  ks[1]).statistic
        assert stat < 2.9 / _N ** 0.5, (name, stat)


def test_np_random_multinomial_permutation_shuffle_and_seed():
    tmx.random.seed(5)
    counts = np.random.multinomial(20, [0.2, 0.3, 0.5], size=(4000,))
    want = jnp_.random.multinomial(20, [0.2, 0.3, 0.5], size=(4000,))
    assert counts.shape == want.shape and counts.dtype == want.dtype
    c = counts.asnumpy()
    assert (c.sum(-1) == 20).all()
    _moments_ok(c[:, 2], 10.0, 20 * 0.25, "multinomial")
    p = np.random.permutation(10).asnumpy()
    assert sorted(p.tolist()) == list(range(10))
    x = np.arange(10)
    np.random.shuffle(x)
    assert sorted(x.asnumpy().tolist()) == list(range(10))
    np.random.seed(9)
    a = np.random.uniform(size=(5,)).asnumpy()
    np.random.seed(9)
    onp.testing.assert_array_equal(np.random.uniform(size=(5,)).asnumpy(),
                                   a)


# ---------------------------------------------------------------------------
# the class machinery, on every route
# ---------------------------------------------------------------------------


def test_class_on_eager_invoke_invoke_fn_and_overrides():
    a = np.array(_A)
    assert type(registry.invoke("relu", [a])) is np.ndarray
    assert type(registry.invoke("relu", [a.as_nd_ndarray()])) \
        is tmx.nd.NDArray
    (out,) = registry.invoke_fn(lambda t: (t * 2,), [a])
    assert type(out) is np.ndarray
    assert type(registry.invoke("_npi_unique", [a])) is np.ndarray
    assert type(registry.invoke("_npi_unique", [a.as_nd_ndarray()])) \
        is tmx.nd.NDArray
    for res in (a + 1, a * a, -a, a.T, a[0], a.detach(), a.copy(),
                a.astype("float16"), a.as_in_context(tmx.cpu()),
                tmx.nd.relu(a), tmx.npx.relu(a), a.sum(), a.reshape(-1)):
        assert type(res) is np.ndarray, res


def test_class_on_a_deferred_bulk_op():
    a = np.array(_A)
    with engine.bulk(32):
        b = (a + 1.0) * 2.0
        c = np.sum(b, axis=0)
        assert b._pending is not None and c._pending is not None
        assert type(b) is np.ndarray and type(c) is np.ndarray
    want = jnp_.sum((jnp_.array(_A) + 1.0) * 2.0, axis=0)
    _close(c.asnumpy(), want.asnumpy())


class _Fwd(gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.fc = gluon.nn.Dense(3, in_units=4)

    def forward(self, x):
        return self.fc(x) * 2


class _HF(gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.fc = gluon.nn.Dense(3, in_units=4)

    seen = []

    def hybrid_forward(self, F, x):
        self.seen.append(type(x))
        return F.relu(self.fc(x))


@pytest.mark.parametrize("cls", [gluon.nn.Dense, _Fwd, _HF])
@pytest.mark.parametrize("hybrid", [False, True])
def test_class_through_gluon_blocks(cls, hybrid):
    """A block called with ``mx.np`` arrays gives ``mx.np`` arrays, with
    NDArrays NDArrays, eager and hybridized (``hybrid_forward`` sees
    ``mx.np`` inputs); the two calls key one signature, and recorded
    calls fill the same gradients."""
    net = cls(3, in_units=4) if cls is gluon.nn.Dense else cls()
    net.initialize()
    if hybrid:
        net.hybridize()
    x = onp.random.RandomState(0).randn(2, 4).astype(onp.float32)
    _HF.seen.clear()
    out_np = net(np.array(x))
    out_nd = net(tmx.nd.array(x))
    assert type(out_np) is np.ndarray and type(out_nd) is tmx.nd.NDArray
    if cls is _HF:
        assert _HF.seen == [np.ndarray, tmx.nd.NDArray]
    onp.testing.assert_array_equal(out_np.asnumpy(), out_nd.asnumpy())
    with autograd.record():
        loss = net(np.array(x)).sum()
    assert type(loss) is np.ndarray
    loss.backward()
    g_np = [p.grad().asnumpy() for p in net.collect_params().values()]
    with autograd.record():
        loss = net(tmx.nd.array(x)).sum()
    loss.backward()
    g_nd = [p.grad().asnumpy() for p in net.collect_params().values()]
    for a, b in zip(g_np, g_nd):
        onp.testing.assert_array_equal(a, b)


def test_the_class_stays_out_of_call_signatures():
    """The graph cache keys a call by its tensors: an ``mx.np`` call and
    an ``mx.nd`` call of the same shapes map to one key."""
    from mxnet_tpu_torch import graph_cache

    net = _Fwd()
    net.initialize()
    net.hybridize()
    keys = []
    orig = graph_cache.signature

    def spy(args, training=False):
        keys.append(orig(args, training))
        return keys[-1]

    graph_cache.signature = spy
    try:
        net(np.array(_A[:2, :]))
        net(tmx.nd.array(_A[:2, :]))
    finally:
        graph_cache.signature = orig
    assert keys and len(set(keys)) == 1


def test_np_arrays_are_never_compared_by_the_engine_or_trainer():
    """``mx.np.ndarray.__eq__`` gives an array and the class is not
    hashable: a Trainer step, a bulked recorded chain and a backward on
    np arrays run without holding them in sets or comparing them."""
    with pytest.raises(TypeError):
        hash(np.array(_A))
    net = gluon.nn.Dense(2, in_units=4)
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = np.array(_A)
    with engine.bulk(16), autograd.record():
        loss = (net(x) * 1.5 + 1.0).mean()
    loss.backward()
    trainer.step(1)
    assert isinstance(loss, np.ndarray)


# ---------------------------------------------------------------------------
# the numpy-mode BERT script at bert_small, against the JAX package's
# ---------------------------------------------------------------------------

_VOCAB, _IGNORE = 50, -1


def _script_step(mx, net, trainer, toks, labels):
    """The numpy-mode script's step: logits, the masked mean NLL through
    ``npx.pick``/``npx.log_softmax``, backward, ``trainer.step(1)``, and
    the accuracy outside ``record()``."""
    t = mx.np.array(toks)
    y = mx.np.array(labels)
    with mx.autograd.record():
        logits = net(t)
        mask = (y != _IGNORE).astype("float32")
        nll = -mx.npx.pick(mx.npx.log_softmax(logits), y.reshape(-1))
        loss = (nll * mask.reshape(-1)).sum() / mask.sum()
    loss.backward()
    trainer.step(1)
    acc = (logits.argmax(axis=-1) == y.reshape(-1)).mean()
    return logits, mask, nll, loss, acc


def _mlm(mx, gl, inner):
    if mx is jmx:
        class MLM(gl.HybridBlock):
            def __init__(self, net):
                super().__init__()
                self.inner = net

            def hybrid_forward(self, F, toks):
                return F.reshape(self.inner(toks)[2], shape=(-1, _VOCAB))
    else:
        class MLM(gl.HybridBlock):
            def __init__(self, net):
                super().__init__()
                self.inner = net

            def forward(self, toks):
                return self.inner(toks)[2].reshape(-1, _VOCAB)
    return MLM(inner)


@pytest.mark.parametrize("hybrid", [False, True])
def test_numpy_mode_bert_script_matches_jax(hybrid):
    """Three steps of the script at ``bert_small`` (2 x 16 tokens, vocab
    50, adamw) in both packages from the same weights: every output is an
    ``mx.np.ndarray``, logits within 1e-5 of their largest value, losses
    within 1e-5 relative, the accuracy equal."""
    rs = onp.random.RandomState(0)
    toks = rs.randint(0, _VOCAB, (2, 16)).astype(onp.int32)
    labels = rs.randint(0, _VOCAB, (2, 16)).astype(onp.float32)
    jmx.random.seed(0)
    jinner = jbert.bert_small(vocab_size=_VOCAB)
    jinner.initialize(jmx.init.Xavier())
    jinner(jmx.nd.array(toks))
    inner = bert.bert_small(vocab_size=_VOCAB, device="cpu")
    bert.load_jax_params(inner, {
        k: p.data().asnumpy()
        for k, p in jinner._collect_params_with_prefix().items()})
    # the MLM loss over tokens alone reaches neither the pooler nor the
    # token-type embedding (the chip script's rule)
    for net_ in (jinner, inner):
        for unused in (net_.pooler, net_.type_embed):
            unused.collect_params().setattr("grad_req", "null")
    jnet, net = _mlm(jmx, jgluon, jinner), _mlm(tmx, gluon, inner)
    if hybrid:
        jnet.hybridize()
        net.hybridize()
    opt = {"learning_rate": 1e-3, "wd": 0.01}
    jtr = jgluon.Trainer(jnet.collect_params(), "adamw", dict(opt))
    tr = gluon.Trainer(net.collect_params(), "adamw", dict(opt))
    tmx.npx.set_np()
    jmx.npx.set_np()
    losses = []
    for _ in range(3):
        got = _script_step(tmx, net, tr, toks, labels)
        want = _script_step(jmx, jnet, jtr, toks, labels)
        for g in got:
            assert type(g) is np.ndarray, type(g)
        logits, mask, nll, loss, acc = got
        assert logits.dtype == onp.float32 and mask.dtype == onp.float32
        _close(logits.asnumpy(), want[0].asnumpy(), 1e-5, "logits")
        onp.testing.assert_allclose(loss.item(), want[3].item(), rtol=1e-5)
        assert acc.item() == want[4].item()
        losses.append(loss.item())
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# the rest of the namespace, with attributes away from their defaults
# ---------------------------------------------------------------------------
_I = onp.array([[3, -1, 4], [1, -5, 9]], onp.int32)
_REST = [
    ("full", ((2, 3), 2.5), {}), ("full", ((2,), 7), {"dtype": "int32"}),
    ("linspace", (0.0, 1.0), {"num": 7}),
    ("linspace", (-1.0, 2.0), {"num": 4, "endpoint": False}),
    ("logspace", (0.0, 2.0), {"num": 5, "base": 2.0}),
    ("eye", (3,), {"M": 4, "k": 1}), ("identity", (3,), {}),
    ("arange", (2, 9, 2), {"dtype": "int32"}), ("arange", (5,), {}),
    ("zeros", ((2, 3),), {"dtype": "int32"}), ("ones", ((0, 3),), {}),
    ("meshgrid", (_V[:3], _V[:2]), {}),
    ("meshgrid", (_V[:3], _V[:2]), {"indexing": "ij"}),
    ("where", (_A > 0.8, _A, 0.0), {}),
    ("nonzero", (_A > 0.8,), {}),
    ("split", (_A, [1, 3]), {"axis": 1}),
    ("array_split", (_A, 2), {"axis": 0}),
    ("tile", (_V, 2), {}), ("repeat", (_A, 2), {}),
    ("argsort", (_A,), {"axis": 0}), ("sort", (_B,), {"axis": 0}),
    ("average", (_A,), {"axis": 1, "weights": _B}),
    ("std", (_A,), {"axis": 0, "ddof": 1}),
    ("var", (_A,), {"axis": (0, 1), "keepdims": True}),
    ("sum", (_A,), {"axis": 1, "keepdims": True}),
    ("sum", (_I,), {"axis": 0}), ("sum", (_I,), {"dtype": "float32"}),
    ("mean", (_I,), {"axis": 1}), ("prod", (_I,), {"axis": 1}),
    ("max", (_A,), {"axis": 1}), ("min", (_I,), {"axis": 0}),
    ("all", (_A > 0.4,), {"axis": 0}), ("any", (_A > 1.5,), {}),
    ("cumsum", (_I,), {"axis": 1}), ("cumsum", (_A,), {"axis": 0}),
    ("argmax", (_A,), {"axis": 1}), ("argmin", (_B,), {"axis": 0}),
    ("tensordot", (_A, _B), {"axes": ([0, 1], [0, 1])}),
    ("tensordot", (_A, _B.T.copy()), {"axes": 1}),
    ("one_hot", (onp.array([0, 2, 5], onp.float32), 4), {}),
    ("isclose", (_A, _A + 1e-7), {}),
    ("take", (_A, onp.array([2, 0], onp.int32)), {"axis": 1}),
    ("cumprod", (_A,), {"axis": 1}),
    ("percentile", (_A, 40.0), {"axis": 1, "keepdims": True}),
    ("percentile", (_A, 40.0), {"interpolation": "lower"}),
    ("quantile", (_A, 0.25), {"axis": 0, "interpolation": "higher"}),
    ("median", (_A,), {"axis": 0, "keepdims": True}),
    ("histogram", (_A,), {"bins": onp.array([0.3, 0.8, 1.5, 2.0],
                                            onp.float32)}),
    ("cov", (_A[0], _B[0]), {}), ("cov", (_A,), {"rowvar": False}),
    ("corrcoef", (_A,), {"rowvar": False}),
    ("trapz", (_A,), {"dx": 0.5, "axis": 0}),
    ("trapz", (_A, _V[:4]), {}),
    ("in1d", (_A, onp.array([0.3], onp.float32)), {}),
    ("isin", (_A, onp.array([0.3], onp.float32)), {"invert": True}),
    ("nan_to_num", (_NAN,), {"nan": 2.0}),
    ("nanmean", (_NAN,), {"axis": 1}), ("nanmax", (_NAN,), {"axis": 0}),
    ("nansum", (_NAN,), {"axis": 1}), ("nanprod", (_NAN,), {}),
    ("nanargmax", (_NAN,), {"axis": 1}), ("ptp", (_A,), {"axis": 0}),
    ("diff", (_A,), {"n": 2, "axis": 0}),
    ("ediff1d", (_V,), {"to_begin": -1.0, "to_end": [7.0, 8.0]}),
    ("digitize", (_V, onp.array([0.3, 0.6], onp.float32)), {"right": True}),
    ("polyval", (onp.array([2.0, 0.5], onp.float32), _A), {}),
    ("cross", (_A[:, :3].copy(), _B[:, :3].copy()), {}),
    ("flip", (_A,), {}), ("roll", (_A, 5), {}),
    ("rot90", (_A,), {"k": 2}), ("tril", (_A,), {"k": 1}),
    ("triu", (_A,), {"k": -1}), ("diag", (_A,), {"k": 1}),
    ("trace", (_A,), {"offset": 1}),
    ("transpose", (_A[None],), {"axes": (2, 0, 1)}),
    ("squeeze", (_A[None, :, None],), {"axis": 0}),
    ("moveaxis", (_A[None],), {"source": 2, "destination": 0}),
    ("concatenate", ([_A, _B],), {"axis": 1}),
    ("stack", ([_A, _B],), {"axis": 2}), ("dstack", ([_A, _B],), {}),
    ("column_stack", ([_V, _V],), {}),
    ("pad", (_SQ, 1), {"mode": "edge"}),
    ("pad", (_SQ, ((0, 1), (2, 0))), {"mode": "reflect"}),
    ("clip", (_A, None, 1.0), {}), ("round", (_A * 10, 1), {}),
    ("maximum", (_A, 0.9), {}), ("minimum", (0.9, _A), {}),
    ("power", (2.0, _A), {}), ("mod", (_I, 4), {}),
    ("subtract", (1.5, _A), {}), ("true_divide", (_I, 4), {}),
    ("divide", (2, _A), {}), ("floor_divide", (_A, 0.3), {}),
    ("fmax", (_NAN, 2.0), {}), ("equal", (_I, 1), {}),
    ("less_equal", (_A, _B), {}), ("logical_and", (_A > 0.5, True), {}),
    ("absolute", (_I,), {}), ("sign", (_I,), {}), ("square", (_I,), {}),
    ("negative", (_I,), {}), ("floor", (_I,), {}), ("sqrt", (_I,), {}),
    ("exp", (_I,), {}), ("sigmoid", (_A,), {}), ("relu", (_A - 1.0,), {}),
    ("fabs", (_I,), {}), ("spacing", (_A,), {}), ("positive", (_A,), {}),
    ("broadcast_arrays", (_V[None], _A[:, :1]), {}),
    ("unique", (onp.array([[1, 2], [1, 2], [3, 4]], onp.int32),),
     {"axis": 0}),
    ("unique", (onp.array([2.0, 1.0, 2.0], onp.float32),),
     {"return_inverse": True}),
    ("bincount", (onp.array([0, 1, 1, 3], onp.int32),), {"minlength": 6}),
    ("bincount", (onp.array([0, 1, 1, 3], onp.int32),),
     {"weights": onp.array([0.5, 1.0, 2.0, 0.25], onp.float32)}),
    ("searchsorted", (onp.array([1., 2., 4., 8.], onp.float32),
                      onp.array([2., 0.5], onp.float32)), {"side": "right"}),
    ("interp", (onp.array([0.5, 1.5, 3.5], onp.float32),
                onp.array([1., 2., 3.], onp.float32),
                onp.array([10., 20., 30.], onp.float32)), {}),
]


def _call(mx, name, args, kw):
    def conv(x):
        if isinstance(x, onp.ndarray):
            return mx.np.array(x)
        if isinstance(x, list) and x and isinstance(x[0], onp.ndarray):
            return [mx.np.array(i) for i in x]
        return x
    kw = {k: conv(v) for k, v in kw.items()}
    return _outs(getattr(mx.np, name)(*[conv(a) for a in args], **kw))


@pytest.mark.parametrize("name,args,kw", _REST,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(_REST)])
def test_namespace_matches_jax(name, args, kw):
    """Each function through both packages: class, dtype and shape
    equal, values within 2e-6 of the largest (1e-5 for the statistics
    that sum in another order)."""
    got, want = _call(tmx, name, args, kw), _call(jmx, name, args, kw)
    assert len(got) == len(want), name
    rel = 1e-5 if name in ("cov", "corrcoef", "std", "var", "average",
                           "percentile", "quantile", "tensordot") else 2e-6
    for g, w in zip(got, want):
        assert type(g) is np.ndarray, (name, type(g))
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        _close(g.asnumpy(), w.asnumpy(), rel, name)
