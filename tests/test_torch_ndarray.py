"""The port's imperative ops (``mxnet_tpu_torch.nd``) against the JAX
package's (``mxnet_tpu.nd``) on the same seeded inputs.

Each case of ``test_op_matches_jax`` feeds one op of ``ops/tensor.py``
the same numpy inputs in both packages (the port on the host, through
``with mx.cpu():``) and compares the outputs: exactly for integer,
boolean, shape and selection results, within ``rtol``/``atol`` (1e-5 /
1e-6 unless the case says otherwise) for float results, whose
transcendental functions differ between XLA:CPU and ATen in the last
bits.  The other tests cover indexing, the in-place operators and
contexts.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError


def _rng(seed):
    return np.random.default_rng(seed)


def normal(*shape, seed=0, lo=None, hi=None):
    rng = _rng(seed + 17 * len(shape))
    if lo is not None:
        return rng.uniform(lo, hi, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def ints(*shape, lo=-2, hi=3, seed=0):
    return _rng(seed).integers(lo, hi, size=shape).astype(np.float32)


X = normal(3, 4)
X3 = normal(2, 3, 4, seed=1)
POS = normal(3, 4, lo=0.2, hi=3.0)
UNIT = normal(3, 4, lo=-0.9, hi=0.9)
HALVES = np.array([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 0.3, -0.7],
                   [3.5, -3.5, 0.0, 7.25]], np.float32)
SPECIAL = np.array([[0.0, np.nan, np.inf, -np.inf], [1.0, -1.0, 2.0, 3.0],
                    [np.nan, 0.5, -0.5, 4.0]], np.float32)


# (case id, op, inputs, attrs[, tolerance overrides])
CASES = []

for _name in ("elemwise_add", "elemwise_sub", "elemwise_mul",
              "elemwise_div", "_maximum", "_minimum", "_hypot"):
    CASES.append((_name, _name, [X, normal(3, 4, seed=2)], {}))
CASES += [
    ("_mod", "_mod", [normal(3, 4, lo=-3, hi=3), normal(3, 4, lo=0.5,
                                                         hi=2, seed=3)], {}),
    ("_power", "_power", [POS, normal(3, 4, lo=-1.5, hi=1.5, seed=4)], {}),
]
for _name in ("_equal", "_not_equal", "_greater", "_greater_equal",
              "_lesser", "_lesser_equal", "_logical_and", "_logical_or",
              "_logical_xor"):
    CASES.append((_name, _name, [ints(3, 4), ints(3, 4, seed=5)], {}))
for _name in ("add", "sub", "mul", "div", "maximum", "minimum", "hypot",
              "equal", "greater", "lesser_equal", "logical_or"):
    CASES.append(("broadcast_" + _name, "broadcast_" + _name,
                  [ints(3, 4) + 0.5 * X, ints(1, 4, seed=6)], {}))
CASES += [
    ("broadcast_mod", "broadcast_mod", [X3, normal(1, 3, 1, lo=0.5, hi=2)],
     {}),
    ("broadcast_power", "broadcast_power", [normal(2, 3, 4, lo=0.2, hi=2),
                                            normal(3, 1, lo=-1, hi=2)], {}),
]
for _name, _s in (("_plus_scalar", 1.5), ("_minus_scalar", 1.5),
                  ("_rminus_scalar", 1.5), ("_mul_scalar", -2.5),
                  ("_div_scalar", 3.0), ("_rdiv_scalar", 2.0),
                  ("_mod_scalar", 0.75), ("_rmod_scalar", 2.5),
                  ("_power_scalar", 2.0), ("_maximum_scalar", 0.25),
                  ("_minimum_scalar", 0.25), ("_equal_scalar", 1.0),
                  ("_not_equal_scalar", 1.0), ("_greater_scalar", 0.0),
                  ("_greater_equal_scalar", 1.0), ("_lesser_scalar", 0.0),
                  ("_lesser_equal_scalar", -1.0),
                  ("_logical_and_scalar", 1.0), ("_logical_or_scalar", 0.0),
                  ("_logical_xor_scalar", 1.0)):
    _inp = ints(3, 4) if "equal" in _name or "logical" in _name \
        or "greater" in _name or "lesser" in _name else X
    CASES.append((_name, _name, [_inp], {"scalar": _s}))
CASES += [
    ("_rpower_scalar", "_rpower_scalar", [X], {"scalar": 2.0}),
    ("_mod_scalar_neg", "_mod_scalar", [normal(3, 4, lo=-3, hi=3)],
     {"scalar": -0.75}),
]

_UNARY_INPUT = {
    "log": POS, "log2": POS, "log10": POS, "sqrt": POS, "rsqrt": POS,
    "gamma": POS, "gammaln": POS, "reciprocal": POS, "rcbrt": POS,
    "log1p": POS, "arcsin": UNIT, "arccos": UNIT, "arctanh": UNIT,
    "erfinv": UNIT, "arccosh": POS + 1.0, "rint": HALVES, "round": HALVES,
    "fix": HALVES, "trunc": HALVES, "ceil": HALVES, "floor": HALVES,
    "isnan": SPECIAL, "isinf": SPECIAL, "isfinite": SPECIAL,
    "logical_not": ints(3, 4),
}
for _name in ("abs", "sign", "ceil", "floor", "rint", "round", "trunc",
              "fix", "exp", "log", "log2", "log10", "log1p", "expm1", "sqrt",
              "rsqrt", "cbrt", "rcbrt", "square", "reciprocal", "negative",
              "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh",
              "cosh", "tanh", "arcsinh", "arccosh", "arctanh", "degrees",
              "radians", "sigmoid", "softsign", "relu", "erf", "erfinv",
              "gamma", "gammaln", "logical_not", "isnan", "isinf",
              "isfinite"):
    CASES.append((_name, _name, [_UNARY_INPUT.get(_name, X)], {},
                  {"rtol": 2e-5, "atol": 2e-6}))
CASES += [
    ("identity", "identity", [X], {}),
    ("_copy", "_copy", [X], {}),
    ("stop_gradient", "stop_gradient", [X], {}),
    ("BlockGrad", "BlockGrad", [X], {}),
    ("cast_int32", "cast", [X * 3], {"dtype": "int32"}),
    ("cast_float16", "cast", [X], {"dtype": "float16"}),
    ("cast_bfloat16", "cast", [X], {"dtype": "bfloat16"}),
    ("Cast", "Cast", [ints(3, 4, lo=0, hi=5)], {"dtype": "uint8"}),
]
for _name in ("sum", "mean", "prod", "max", "min", "nansum", "nanprod"):
    _inp = SPECIAL if _name.startswith("nan") else X3
    for _tag, _attrs in (("all", {}), ("axis1", {"axis": 1}),
                         ("axes02_keep", {"axis": (0, 2), "keepdims": True}),
                         ("exclude", {"axis": 1, "exclude": True}),
                         ("empty_axes", {"axis": ()})):
        if _name.startswith("nan") and "axes02" in _tag:
            continue
        CASES.append(("%s_%s" % (_name, _tag), _name, [_inp], _attrs,
                      {"rtol": 1e-5, "atol": 1e-5}))
CASES += [
    ("sum_axis", "sum_axis", [X3], {"axis": 2}),
    ("norm_l2", "norm", [X3], {}),
    ("norm_l1_axis", "norm", [X3], {"ord": 1, "axis": 1}),
    ("norm_l2_axes_keep", "norm", [X3], {"axis": (0, 2), "keepdims": True}),
    ("argmax", "argmax", [X3], {}),
    ("argmax_axis", "argmax", [X3], {"axis": 1}),
    ("argmax_keep", "argmax", [X3], {"axis": -1, "keepdims": True}),
    ("argmax_ties", "argmax", [ints(3, 4)], {"axis": 1}),
    ("argmin", "argmin", [X3], {"axis": 0}),
    ("argmin_flat", "argmin", [X3], {}),
    ("argmax_channel", "argmax_channel", [X3], {}),
    ("cumsum", "cumsum", [X3], {}),
    ("cumsum_axis", "cumsum", [X3], {"axis": 1}),
    ("logsumexp", "logsumexp", [X3], {}),
    ("logsumexp_axis", "logsumexp", [X3], {"axis": 2, "keepdims": True}),
]
CASES += [
    ("reshape", "reshape", [X3], {"shape": (4, 6)}),
    ("reshape_0_m1", "reshape", [X3], {"shape": (0, -1)}),
    ("reshape_m2", "reshape", [X3], {"shape": (2, -2)}),
    ("reshape_m3", "reshape", [X3], {"shape": (-3, 4)}),
    ("reshape_m4", "reshape", [X3], {"shape": (-4, 1, 2, -2)}),
    ("Reshape", "Reshape", [X3], {"shape": (-1,)}),
    ("reshape_like", "reshape_like", [X3, normal(6, 4)], {}),
    ("flatten", "flatten", [X3], {}),
    ("Flatten", "Flatten", [normal(2, 3, 2, 2)], {}),
    ("transpose", "transpose", [X3], {}),
    ("transpose_axes", "transpose", [X3], {"axes": (1, 0, 2)}),
    ("swapaxes", "swapaxes", [X3], {"dim1": 0, "dim2": 2}),
    ("expand_dims", "expand_dims", [X3], {"axis": 1}),
    ("expand_dims_neg", "expand_dims", [X3], {"axis": -1}),
    ("squeeze", "squeeze", [normal(3, 1, 4, 1)], {}),
    ("squeeze_axis", "squeeze", [normal(3, 1, 4, 1)], {"axis": 1}),
    ("depth_to_space", "depth_to_space", [normal(1, 8, 2, 3)],
     {"block_size": 2}),
    ("space_to_depth", "space_to_depth", [normal(1, 2, 4, 6)],
     {"block_size": 2}),
    ("broadcast_to", "broadcast_to", [normal(3, 1)], {"shape": (3, 5)}),
    ("broadcast_to_zero", "broadcast_to", [normal(1, 4)], {"shape": (2, 0)}),
    ("broadcast_like", "broadcast_like", [normal(1, 4), X], {}),
    ("broadcast_axis", "broadcast_axis", [normal(3, 1, 1)],
     {"axis": (1, 2), "size": (2, 5)}),
    ("tile", "tile", [X], {"reps": (2, 3)}),
    ("tile_short", "tile", [X3], {"reps": (2,)}),
    ("repeat", "repeat", [X], {"repeats": 2}),
    ("repeat_axis", "repeat", [X], {"repeats": 3, "axis": 1}),
    ("reverse", "reverse", [X3], {"axis": 1}),
    ("flip", "flip", [X3], {"axis": (0, 2)}),
    ("concat", "concat", [X, normal(3, 2)], {"dim": 1}),
    ("Concat", "Concat", [X, normal(2, 4), normal(1, 4)], {"dim": 0}),
    ("stack", "stack", [X, normal(3, 4, seed=9)], {"axis": 1}),
    ("split", "split", [normal(2, 6)], {"num_outputs": 3}),
    ("split_squeeze", "split", [normal(2, 3)],
     {"num_outputs": 3, "axis": 1, "squeeze_axis": True}),
    ("SliceChannel", "SliceChannel", [normal(4, 2)],
     {"num_outputs": 2, "axis": 0}),
    ("split_v2", "split_v2", [normal(7, 3)], {"indices": (2, 5)}),
    ("split_v2_sections", "split_v2", [normal(6, 3)],
     {"sections": 3, "axis": 0}),
    ("slice", "slice", [X3], {"begin": (0, 1), "end": (2, 3)}),
    ("slice_none", "slice", [X3], {"begin": (None, 1), "end": (None, None)}),
    ("slice_step", "slice", [X3],
     {"begin": (0, 0, 0), "end": (2, 3, 4), "step": (1, 2, 3)}),
    ("slice_neg_step", "slice", [X3],
     {"begin": (None, 2), "end": (None, None), "step": (1, -1)}),
    ("slice_neg_bounds", "slice", [X3], {"begin": (-1, -2), "end": (None, -1)}),
    ("slice_axis", "slice_axis", [X3], {"axis": 2, "begin": 1, "end": 3}),
    ("slice_axis_neg", "slice_axis", [X3],
     {"axis": -1, "begin": -3, "end": None}),
    ("slice_like", "slice_like", [X3, normal(1, 2, 3)], {}),
    ("slice_like_axes", "slice_like", [X3, normal(2, 2, 2)], {"axes": (2,)}),
    ("pad_constant", "pad", [normal(1, 2, 3, 4)],
     {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
      "constant_value": 1.5}),
    ("pad_edge", "pad", [normal(1, 2, 3, 4)],
     {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}),
    ("Pad_reflect", "Pad", [normal(1, 2, 3, 4)],
     {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}),
    ("clip", "clip", [X], {"a_min": -0.5, "a_max": 0.7}),
    ("clip_low", "clip", [X], {"a_min": 0.0}),
    ("take", "take", [X, np.array([[0, 2], [1, 1]], np.float32)], {}),
    ("take_clip", "take", [X, np.array([-3.0, 1.7, 9.0], np.float32)], {}),
    ("take_wrap_axis", "take", [X3, np.array([-1.0, 3.0, 5.0], np.float32)],
     {"axis": 1, "mode": "wrap"}),
    ("pick", "pick", [X, np.array([0.0, 3.0, 1.0], np.float32)], {}),
    ("pick_axis0_keep", "pick", [X, np.array([2.0, 0.0, 5.0, 1.0],
                                              np.float32)],
     {"axis": 0, "keepdims": True}),
]
CASES += [
    ("_zeros", "_zeros", [], {"shape": (2, 3)}),
    ("_ones_int", "_ones", [], {"shape": (4,), "dtype": "int32"}),
    ("_full", "_full", [], {"shape": (2, 2), "value": 3.25}),
    ("_arange", "_arange", [], {"start": 2.0, "stop": 11.0, "step": 1.5}),
    ("_arange_stop", "_arange", [], {"start": 5}),
    ("_arange_repeat", "_arange", [], {"start": 0.0, "stop": 3.0,
                                       "repeat": 2}),
    ("_linspace", "_linspace", [], {"start": -1.0, "stop": 2.0, "num": 7}),
    ("_linspace_open", "_linspace", [], {"start": 0.0, "stop": 1.0, "num": 4,
                                         "endpoint": False}),
    ("_eye", "_eye", [], {"N": 3, "M": 5, "k": 1}),
    ("_eye_square", "_eye", [], {"N": 4, "k": -2}),
    ("zeros_like", "zeros_like", [X3], {}),
    ("ones_like", "ones_like", [X3], {}),
    ("full_like", "full_like", [X3], {"fill_value": -2.0}),
    ("dot", "dot", [X, normal(4, 5)], {}, {"rtol": 1e-5, "atol": 1e-5}),
    ("dot_ta", "dot", [normal(4, 3), normal(4, 5)], {"transpose_a": True},
     {"rtol": 1e-5, "atol": 1e-5}),
    ("dot_tb", "dot", [X, normal(5, 4)], {"transpose_b": True},
     {"rtol": 1e-5, "atol": 1e-5}),
    ("dot_vec", "dot", [normal(6), normal(6, seed=3)], {},
     {"rtol": 1e-5, "atol": 1e-5}),
    ("dot_3d", "dot", [X3, normal(4, 2)], {}, {"rtol": 1e-5, "atol": 1e-5}),
    ("batch_dot", "batch_dot", [X3, normal(2, 4, 5)], {},
     {"rtol": 1e-5, "atol": 1e-5}),
    ("batch_dot_t", "batch_dot", [normal(2, 4, 3), normal(2, 5, 4)],
     {"transpose_a": True, "transpose_b": True},
     {"rtol": 1e-5, "atol": 1e-5}),
]


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _host(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, inputs, attrs = case[:4]
    tol = {"rtol": 1e-5, "atol": 1e-6}
    if len(case) > 4:
        tol.update(case[4])
    want = _as_list(getattr(jmx.nd, op)(*[jmx.nd.array(x) for x in inputs],
                                        **attrs))
    with tmx.cpu():
        got = _as_list(getattr(tmx.nd, op)(*[tmx.nd.array(x)
                                             for x in inputs], **attrs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.context == tmx.cpu()
        w = _host(w.asnumpy())
        g = g.asnumpy()
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind in "biu" or g.dtype.kind in "biu":
            assert g.dtype == w.dtype, (g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), equal_nan=True,
                                       **tol)


def test_ndarray_methods_match_jax():
    """The method forms of the shape and reduction ops."""
    def run(mx):
        a = mx.nd.array(X3)
        return [a.reshape((4, 6)), a.reshape(4, -1), a.flatten(),
                a.expand_dims(0), a.transpose(), a.T, a.swapaxes(0, 1),
                a.sum(axis=1), a.mean(), a.max(axis=(0, 2)),
                a.min(keepdims=True), a.prod(axis=0), a.norm(),
                a.argmax(axis=2), a.argmin(), a.clip(-0.3, 0.3), a.abs(),
                a.sign(), a.square(), a.exp(), a.relu(), a.sigmoid(),
                a.tanh(), a.slice_axis(1, 0, 2), a.flip(2),
                a.broadcast_to((2, 3, 4)), a.tile((1, 2, 1)),
                a.take(mx.nd.array([1.0, 0.0]), axis=1),
                a.reshape((6, 4)).dot(mx.nd.array(normal(4, 2))),
                a.astype("int32"), a.split(2, axis=2)[1], abs(a), -a,
                a.pad("constant", (0, 0, 0, 0, 1, 1)).squeeze(),
                mx.nd.moveaxis(a, 0, 2), mx.nd.concatenate([a, a], axis=1),
                mx.nd.zeros_like(a), mx.nd.ones_like(a),
                mx.nd.zeros((2, 2)), mx.nd.ones(3, dtype="int32"),
                mx.nd.full((2,), 4.5), mx.nd.arange(1, 7, 2, repeat=2)]

    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.asnumpy(), _host(w.asnumpy()),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("op,scalar", [
    ("__add__", 1.5), ("__radd__", 1.5), ("__sub__", 0.5), ("__rsub__", 0.5),
    ("__mul__", -3.0), ("__rmul__", 2.0), ("__truediv__", 4.0),
    ("__rtruediv__", 4.0), ("__mod__", 0.7), ("__rmod__", 2.5),
    ("__pow__", 2.0), ("__rpow__", 1.5), ("__eq__", 1.0), ("__ne__", 1.0),
    ("__gt__", 0.0), ("__ge__", 1.0), ("__lt__", 0.0), ("__le__", -1.0)])
def test_arithmetic_dunders_match_jax(op, scalar):
    """Each dunder with a scalar, an NDArray (broadcast) and a list."""
    base = ints(3, 4) + (0.5 if op not in ("__eq__", "__ne__") else 0.0)
    other = ints(1, 4, seed=3, lo=1, hi=3)

    def run(mx):
        a = mx.nd.array(base)
        return [getattr(a, op)(scalar), getattr(a, op)(mx.nd.array(other)),
                getattr(a, op)(other.tolist())]

    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("op", ["__iadd__", "__isub__", "__imul__",
                                "__itruediv__"])
def test_inplace_dunders_write_in_place_and_match_jax(op):
    other = normal(1, 4, lo=0.5, hi=2)

    def run(mx):
        a = mx.nd.array(X)
        a = getattr(a, op)(mx.nd.array(other))
        a = getattr(a, op)(2.0)
        return a

    want = run(jmx).asnumpy()
    with tmx.cpu():
        a = tmx.nd.array(X)
        buf, v0 = a._data, a._var.version
        res = getattr(a, op)(tmx.nd.array(other))
        res = getattr(res, op)(2.0)
        # MXNet's in-place contract: the same array, the same tensor, two
        # writes on its var
        assert res is a and a._data is buf and a._var.version == v0 + 2
        np.testing.assert_allclose(a.asnumpy(), want, rtol=1e-6, atol=1e-6)
        # a result that does not fit (an int array += float) is adopted
        b = tmx.nd.array(ints(3, 4))
        b += 0.5
        assert b.dtype == np.float32


def test_indexing_matches_jax():
    def run(mx):
        a = mx.nd.array(X3)
        out = [a[1], a[0, 2], a[:, 1:3], a[..., ::2], a[1, :, -1],
               a[mx.nd.array([1.0, 0.0])], a[:, mx.nd.array([2.0, 0.0])]]
        b = mx.nd.array(X3)
        b[0] = 1.5
        b[1, 1:3] = mx.nd.array(np.full((2, 4), -2.0, np.float32))
        b[:, :, 0] = np.arange(3, dtype=np.float32)
        b[...] = b * 2
        c = mx.nd.array(X)
        c[:] = 7.0
        return out + [b, c]

    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6)
    # a read by indexing is a copy: writing it leaves the source alone
    with tmx.cpu():
        a = tmx.nd.array(X)
        row = a[0]
        row[:] = 0.0
        np.testing.assert_array_equal(a.asnumpy(), X)


def test_setitem_on_a_recorded_array_raises():
    with tmx.cpu():
        x = tmx.nd.array(X)
        x.attach_grad()
        with tmx.autograd.record():
            y = x * 2
            with pytest.raises(MXNetError, match="taped"):
                y[0] = 1.0


def test_contexts():
    cpu = tmx.cpu()
    assert cpu == tmx.Context("cpu") == torch.device("cpu")
    assert hash(cpu) == hash(tmx.cpu(3)) and cpu.device_typeid == 1
    assert tmx.Context(cpu) == cpu and str(cpu) == "cpu(0)"
    assert tmx.Context("cuda", 1) == tmx.Context("gpu", 1) != cpu
    with pytest.raises(MXNetError, match="unknown device type"):
        tmx.Context("tpu")
    a = tmx.nd.array(X, ctx=tmx.cpu())
    assert a.context == cpu and a._data.device == torch.device("cpu")
    b = tmx.nd.array(X, ctx="cpu")
    assert b.ctx == cpu and b.as_in_context(cpu) is b
    assert tmx.nd.zeros((2,), ctx=torch.device("cpu")).context == cpu
    with tmx.cpu() as c:
        assert tmx.current_context() == c
        with tmx.Context("cpu"):
            assert tmx.current_context() == cpu
        assert tmx.nd.ones((2,)).context == cpu
    if torch.cuda.is_available():
        assert tmx.current_context() == tmx.gpu(0)
        assert tmx.num_gpus() == torch.cuda.device_count()
        return
    # the default context is the card: without CUDA it raises
    assert tmx.num_gpus() == 0
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.current_context()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.nd.array(X)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.nd.zeros((2, 2))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.nd.array(X, ctx=tmx.Context("gpu"))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        a.as_in_context(tmx.Context("gpu", 0))


def test_copies_views_and_host_transfer():
    with tmx.cpu():
        src = X.copy()
        a = tmx.nd.array(src)
        src[0, 0] = 99.0                      # nd.array copies its source
        assert a.asnumpy()[0, 0] == X[0, 0]
        t = torch.from_numpy(X.copy())        # a tensor or an NDArray too
        at, aa = tmx.nd.array(t), tmx.nd.array(a)
        t[0, 0] = 99.0
        aa += 1.0
        assert at.asnumpy()[0, 0] == X[0, 0] == a.asnumpy()[0, 0]
        host = a.asnumpy()
        host[0, 0] = 42.0                     # asnumpy returns a copy
        assert a.asnumpy()[0, 0] == X[0, 0]
        d = a.detach()                        # detach shares the tensor
        d += 1.0
        np.testing.assert_allclose(a.asnumpy(), X + 1.0)
        c = a.copy()
        c += 1.0
        np.testing.assert_allclose(a.asnumpy(), X + 1.0)
        dst = tmx.nd.zeros((3, 4))
        v0 = dst._var.version
        assert a.copyto(dst) is dst and dst._var.version == v0 + 1
        np.testing.assert_allclose(dst.asnumpy(), X + 1.0)
        out = tmx.nd.zeros((3, 4))
        buf = out._data
        tmx.nd.broadcast_add(a, a, out=out)
        assert out._data is buf
        from mxnet_tpu_torch.ops import registry
        raw, vjp, _ = registry.invoke_raw("broadcast_add", [a._data, a._data])
        assert vjp is None and torch.equal(raw[0], out._data)
        np.testing.assert_allclose(out.asnumpy(), 2 * (X + 1.0))
        assert a.astype("float32", copy=False) is a
        bf = a.astype("bfloat16")
        assert bf.dtype == torch.bfloat16
        assert bf.asnumpy().dtype == np.float32
        assert tmx.nd.array([1, 2]).dtype == np.int32
        assert tmx.nd.array([1.0]).dtype == np.float32
        assert float(tmx.nd.array([2.5]).asscalar()) == 2.5
        assert len(a) == 3 and a.size == 12 and a.ndim == 2
        assert a.stype == "default"
        e = tmx.nd.empty((2, 3), dtype="bfloat16")
        assert e.shape == (2, 3) and e.dtype == torch.bfloat16
        for call in (lambda: a.reshard(), lambda: tmx.nd.shard(a)):
            with pytest.raises(MXNetError, match="not ported"):
                call()
        # sparse storage and dlpack came with S7e
        csr = a.tostype("csr")
        assert csr.stype == "csr"
        np.testing.assert_array_equal(csr.asnumpy(), a.asnumpy())
        view = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_read())
        assert view.data_ptr() == a._data.data_ptr()
        # the ordering methods and one_hot came with the op tail (S7)
        assert a.one_hot(3).shape == (3, 4, 3)
        assert a.topk().shape == (3, 1)
