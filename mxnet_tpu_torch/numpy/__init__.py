"""``mx.np``: the NumPy-compatible frontend (the port's counterpart of
the JAX package's ``numpy/__init__.py``; reference:
``python/mxnet/numpy/multiarray.py`` and
``numpy_dispatch_protocol.py``).

``ndarray`` subclasses the port's ``NDArray``: the same tensor, engine
var and autograd state, with NumPy's semantics on top (zero-dim and
zero-size shapes, ``bool`` comparisons, true division, boolean-mask
reads, ``__array_ufunc__``/``__array_function__``).  There is no second
op stack: an op's results take the class of its first input, so an
``mx.np.ndarray`` stays one through every registry op, Gluon block and
hybridized call.

Routes: a function with a registered ``_np*``/``_npi_*`` op (or an
``mx.nd`` op of the same semantics) calls it through
``registry.invoke``, so it joins the open bulk segment as an ``mx.nd``
op does; the others run a torch closure through ``registry.invoke_fn``
(recorded by torch's autograd inside ``record()``; the open segment
flushes first).  The functions whose output shape depends on the data
(``unique``, ``nonzero``, ``bincount``, the set ops, boolean masks)
read the device on the host, as the JAX package's do, and raise
``MXNetError`` under a CUDA graph capture.

Types follow the JAX package: floats are float32 by default,
``arange(5)`` is float32, comparisons are ``bool``, an integer sum is
int32.  A 64-bit numpy array passed in stays 64-bit, as do 64-bit arrays
through the ops (the JAX package narrows them, its 64-bit types being
off).
"""
from __future__ import annotations

import builtins
import math

import numpy as _onp
import torch

from ..base import MXNetError
from ..context import as_context, current_context  # noqa: F401
from ..ndarray.ndarray import NDArray, _host_tensor
from ..ops import registry as _reg
from ..ops.tensor import to_torch_dtype

__all__ = ["ndarray", "array", "zeros", "ones", "empty", "full", "arange",
           "linspace", "logspace", "eye", "identity", "meshgrid"]

pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None
float32 = _onp.float32
float64 = _onp.float64
float16 = _onp.float16
int8 = _onp.int8
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_


def _as_np(x):
    """``x`` as an ``mx.np.ndarray`` over the same tensor and state (an
    op's result whose first input was a plain NDArray)."""
    if isinstance(x, ndarray) or not isinstance(x, NDArray):
        return x
    out = ndarray.__new__(ndarray)
    for slot in NDArray.__slots__:
        if slot != "__weakref__":
            object.__setattr__(out, slot, getattr(x, slot))
    return out


def _ctx_of(xs):
    for x in xs:
        if isinstance(x, NDArray):
            return x.context
    return None


def _arrs(xs):
    """Each of ``xs`` as an array, numbers and lists on the context of
    the first array among them."""
    ctx = _ctx_of(xs)
    return [x if isinstance(x, NDArray) else array(x, ctx=ctx) for x in xs]


def _invoke(fn, tensors, op_name, n_out=1):
    """Run the torch closure ``fn`` over the arrays ``tensors`` (numbers
    and lists become arrays) through ``registry.invoke_fn``; ``n_out``
    None for a tuple of any length."""
    ins = _arrs(tensors)
    if n_out == 1:
        (out,) = _reg.invoke_fn(lambda *raw: (fn(*raw),), ins,
                                op_name=op_name)
        return _as_np(out)
    outs = _reg.invoke_fn(lambda *raw: tuple(fn(*raw)), ins, op_name=op_name)
    return [_as_np(o) for o in outs]


def _op(name, inputs, attrs=None, out=None):
    """The registry op ``name`` on ``inputs`` (deferred into the open
    bulk segment where it can be), its results as ``mx.np.ndarray``."""
    res = _reg.invoke(name, _arrs(inputs), attrs or {})
    res = [_as_np(r) for r in res] if isinstance(res, (list, tuple)) \
        else _as_np(res)
    return _to_out(res, out)


def _make(name, attrs, ctx):
    """A creation op (no tensor input) on ``ctx``."""
    return _as_np(_reg.invoke(name, [], dict(attrs, ctx=ctx)))


def _to_out(res, out):
    if out is None:
        return res
    out._adopt(res)
    return out


def _axis(axis):
    return tuple(axis) if isinstance(axis, list) else axis


class ndarray(NDArray):
    """A NumPy-semantics array over the port's NDArray machinery."""

    __slots__ = ()

    # comparisons give bool arrays (mx.nd's give the input's type)
    def _cmp(self, other, fn, name):
        if other is None:
            return NotImplemented
        if isinstance(other, NDArray):
            return _invoke(fn, [self, other], name)
        if isinstance(other, (_onp.ndarray, list, tuple)):
            return _invoke(fn, [self, array(other, ctx=self._ctx)], name)
        return _invoke(lambda a: fn(a, other), [self], name)

    def __eq__(self, o):
        return self._cmp(o, torch.eq, "_np_equal")

    def __ne__(self, o):
        return self._cmp(o, torch.ne, "_np_not_equal")

    def __gt__(self, o):
        return self._cmp(o, torch.gt, "_np_greater")

    def __ge__(self, o):
        return self._cmp(o, torch.ge, "_np_greater_equal")

    def __lt__(self, o):
        return self._cmp(o, torch.lt, "_np_less")

    def __le__(self, o):
        return self._cmp(o, torch.le, "_np_less_equal")

    __hash__ = None

    def __truediv__(self, o):
        return true_divide(self, o)

    def __rtruediv__(self, o):
        return true_divide(o, self)

    def __matmul__(self, o):
        return matmul(self, o)

    def __mod__(self, o):
        return mod(self, o)

    def __abs__(self):
        return absolute(self)

    def __repr__(self):
        return "array(%s)" % _onp.array2string(self.asnumpy(),
                                               separator=", ")

    # numpy's dispatch protocols -------------------------------------------
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out") is not None:
            return NotImplemented
        fn = globals().get(ufunc.__name__)
        if fn is None:
            return NotImplemented
        return fn(*inputs)

    def __array_function__(self, func, types, args, kwargs):
        fn = globals().get(func.__name__)
        if fn is None:
            return NotImplemented
        return fn(*args, **kwargs)

    # ndarray methods --------------------------------------------------------
    @property
    def T(self):
        return transpose(self)

    def item(self, *args):
        return self.asnumpy().item(*args)

    def tolist(self):
        return self.asnumpy().tolist()

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if kwargs.get("order", "C") != "C":
            raise MXNetError("only C-order reshape is supported")
        return _op("_np_reshape", [self], {"newshape": tuple(shape)})

    def flatten(self, order="C"):
        return self.reshape((-1,))

    def ravel(self):
        return self.reshape((-1,))

    def squeeze(self, axis=None):
        return squeeze(self, axis)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return transpose(self, axes or None)

    def swapaxes(self, a1, a2):
        return swapaxes(self, a1, a2)

    def sum(self, axis=None, dtype=None, keepdims=False):
        return sum(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def mean(self, axis=None, dtype=None, keepdims=False):
        return mean(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return min(self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return prod(self, axis=axis, keepdims=keepdims)

    def std(self, axis=None, ddof=0, keepdims=False):
        return std(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, ddof=0, keepdims=False):
        return var(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def argmax(self, axis=None):
        return argmax(self, axis=axis)

    def argmin(self, axis=None):
        return argmin(self, axis=axis)

    def cumsum(self, axis=None):
        return cumsum(self, axis=axis)

    def clip(self, a_min=None, a_max=None):
        return clip(self, a_min, a_max)

    def round(self, decimals=0):
        return round(self, decimals)

    def repeat(self, repeats, axis=None):
        return repeat(self, repeats, axis=axis)

    def dot(self, other):
        return dot(self, other)

    def copy(self):
        return _op("_np_copy", [self]) if self.dtype != _onp.bool_ \
            else _as_np(NDArray.copy(self))

    def as_nd_ndarray(self):
        """A classic ``mx.nd`` NDArray over the same tensor and state."""
        out = NDArray.__new__(NDArray)
        for slot in NDArray.__slots__:
            if slot != "__weakref__":
                object.__setattr__(out, slot, getattr(self, slot))
        return out

    def as_np_ndarray(self):
        return self


ndarray._op_result_cls = ndarray


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def array(obj, dtype=None, ctx=None):
    """A new array holding a copy of ``obj``.  Without ``dtype``, float64
    data becomes float32 and Python integers int32, as in the JAX
    package; a 64-bit numpy array keeps its type."""
    if isinstance(obj, NDArray):
        src = obj._data.detach()
        t = src.to(to_torch_dtype(dtype)) if dtype is not None else src
        dev = as_context(ctx).torch_device if ctx is not None else t.device
        t = t.to(dev)
        if t.data_ptr() == src.data_ptr():
            t = t.clone()
        return ndarray._wrap(t, ctx or obj.context)
    if isinstance(obj, torch.Tensor):
        return ndarray(obj.detach().clone(), ctx=ctx, dtype=dtype)
    if isinstance(obj, (list, tuple)) and builtins.any(
            isinstance(x, NDArray) for x in obj):
        obj = [x.asnumpy() if isinstance(x, NDArray) else x for x in obj]
    if dtype is None and isinstance(obj, _onp.ndarray) \
            and obj.dtype in (_onp.int64, _onp.float64):
        t = torch.from_numpy(obj.copy())
    else:
        t = _host_tensor(obj, dtype)
    return ndarray(t, ctx=as_context(ctx))


asarray = array


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype="float32", ctx=None):
    return _make("_npi_zeros", {"shape": _shape(shape),
                                "dtype": dtype or "float32"}, ctx)


def ones(shape, dtype="float32", ctx=None):
    return _make("_npi_ones", {"shape": _shape(shape),
                               "dtype": dtype or "float32"}, ctx)


def empty(shape, dtype="float32", ctx=None):
    """Zeros, as the JAX package gives them."""
    return zeros(shape, dtype, ctx)


def full(shape, fill_value, dtype=None, ctx=None):
    if dtype is None:
        dtype = "bool" if isinstance(fill_value, bool) else \
            "int32" if isinstance(fill_value, int) else "float32"
    z = zeros(shape, dtype, ctx)
    return _op("_npi_full_like", [z], {"fill_value": fill_value,
                                       "dtype": dtype})


def zeros_like(a, dtype=None):
    return _op("_npi_full_like", [a], {"fill_value": 0, "dtype": dtype})


def ones_like(a, dtype=None):
    return _op("_npi_full_like", [a], {"fill_value": 1, "dtype": dtype})


def full_like(a, fill_value, dtype=None):
    return _op("_npi_full_like", [a], {"fill_value": fill_value,
                                       "dtype": dtype})


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    return _make("_npi_arange", {"start": start, "stop": stop, "step": step,
                                 "dtype": dtype or "float32"}, ctx)


def linspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None):
    return _make("_linspace", {"start": start, "stop": stop, "num": num,
                               "endpoint": endpoint,
                               "dtype": dtype or "float32"}, ctx)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None):
    return _make("_npi_logspace", {"start": start, "stop": stop, "num": num,
                                   "endpoint": endpoint, "base": base,
                                   "dtype": dtype or "float32"}, ctx)


def eye(N, M=None, k=0, dtype="float32", ctx=None):
    return _make("_npi_eye", {"N": N, "M": M, "k": k, "dtype": dtype}, ctx)


def identity(n, dtype="float32", ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def meshgrid(*xi, indexing="xy"):
    return _invoke(lambda *xs: torch.meshgrid(*xs, indexing=indexing),
                   list(xi), "_np_meshgrid", None)


# ---------------------------------------------------------------------------
# elementwise math, from one table: (name, registry op or None, closure)
# ---------------------------------------------------------------------------


def _flt(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _keep_int(fn, x):
    """``fn`` of a floating ``x``; an integer ``x`` itself (jnp's floor,
    ceil and trunc keep integer types)."""
    return fn(x) if x.is_floating_point() else x.clone()


_UNARY = {
    "negative": ("negative", None),
    "absolute": ("abs", None),
    "sign": ("sign", None),
    "exp": ("exp", None),
    "expm1": ("expm1", None),
    "log": ("_npi_log", None),
    "log2": ("log2", None),
    "log10": ("log10", None),
    "log1p": ("log1p", None),
    "sqrt": ("sqrt", None),
    "cbrt": ("_npi_cbrt", None),
    "square": ("square", None),
    "reciprocal": (None, lambda a: torch.reciprocal(a)),
    "sin": ("sin", None),
    "cos": ("cos", None),
    "tan": ("tan", None),
    "arcsin": ("arcsin", None),
    "arccos": ("arccos", None),
    "arctan": ("arctan", None),
    "sinh": ("sinh", None),
    "cosh": ("cosh", None),
    "tanh": ("tanh", None),
    "arcsinh": ("arcsinh", None),
    "arccosh": ("arccosh", None),
    "arctanh": ("arctanh", None),
    "degrees": ("degrees", None),
    "radians": ("radians", None),
    "floor": (None, lambda a: _keep_int(torch.floor, a)),
    "ceil": (None, lambda a: _keep_int(torch.ceil, a)),
    "trunc": (None, lambda a: _keep_int(torch.trunc, a)),
    "rint": (None, lambda a: torch.round(_flt(a))),
    "isnan": ("isnan", None),
    "isinf": ("isinf", None),
    "isfinite": ("isfinite", None),
    "logical_not": ("_npi_logical_not", None),
    "sort": (None, lambda a, axis=-1: torch.sort(a, dim=axis,
                                                 stable=True)[0]),
    "deg2rad": ("_npi_deg2rad", None),
    "rad2deg": ("_npi_rad2deg", None),
    "signbit": ("_npi_signbit", None),
    "positive": ("_npi_positive", None),
    "fabs": ("_npi_fabs", None),
    "spacing": ("_npi_spacing", None),
}


def _logical(fn):
    return lambda a, b: fn(a.bool() if a.dtype != torch.bool else a,
                           b.bool() if b.dtype != torch.bool else b)


def _promoted(fn):
    """``fn`` on both operands in their promoted floating type."""
    def f(a, b):
        dt = torch.result_type(a, b)
        if not dt.is_floating_point:
            dt = torch.float32
        return fn(a.to(dt) if isinstance(a, torch.Tensor) else a,
                  b.to(dt) if isinstance(b, torch.Tensor) else b)
    return f


def _true_div(a, b):
    dt = torch.result_type(a, b)
    if not dt.is_floating_point:
        dt = torch.float32
    a = a.to(dt) if isinstance(a, torch.Tensor) else a
    b = b.to(dt) if isinstance(b, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=dt, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=dt, device=a.device)
    return a / b


# name -> (op for two arrays or None, closure of (a, b)); the ops of an
# array and a number, where one gives jnp's weak typing, in _SCALAR_OPS
_BINARY = {
    "add": ("_npi_add", torch.add),
    "subtract": ("_npi_subtract", torch.subtract),
    "multiply": ("_npi_multiply", torch.multiply),
    "divide": ("_npi_true_divide", _true_div),
    "true_divide": ("_npi_true_divide", _true_div),
    "mod": ("_npi_mod", torch.remainder),
    "remainder": ("_npi_mod", torch.remainder),
    "power": ("_npi_power", torch.pow),
    "maximum": ("broadcast_maximum", torch.maximum),
    "minimum": ("broadcast_minimum", torch.minimum),
    "hypot": ("_npi_hypot", _promoted(torch.hypot)),
    "arctan2": ("_npi_arctan2", _promoted(torch.atan2)),
    "logical_and": (None, _logical(torch.logical_and)),
    "logical_or": (None, _logical(torch.logical_or)),
    "logical_xor": (None, _logical(torch.logical_xor)),
    "equal": (None, torch.eq),
    "not_equal": (None, torch.ne),
    "greater": (None, torch.gt),
    "greater_equal": (None, torch.ge),
    "less": (None, torch.lt),
    "less_equal": (None, torch.le),
    "fmax": (None, torch.fmax),
    "fmin": (None, torch.fmin),
    "floor_divide": (None, torch.floor_divide),
    "copysign": ("_npi_copysign", _promoted(torch.copysign)),
    "logaddexp": ("_npi_logaddexp", _promoted(torch.logaddexp)),
    "fmod": ("_npi_fmod", torch.fmod),
    "heaviside": ("_npi_heaviside", _promoted(torch.heaviside)),
    "gcd": ("_npi_gcd", lambda a, b: torch.gcd(a.to(torch.int32),
                                               b.to(torch.int32))),
    "lcm": ("_npi_lcm", lambda a, b: torch.lcm(a.to(torch.int32),
                                               b.to(torch.int32))),
    "nextafter": ("_npi_nextafter", _promoted(torch.nextafter)),
}


_SCALAR_OPS = {
    "add": ("_plus_scalar", "_plus_scalar"),
    "subtract": ("_minus_scalar", "_rminus_scalar"),
    "multiply": ("_mul_scalar", "_mul_scalar"),
    "divide": ("_npi_true_divide_scalar", "_npi_rtrue_divide_scalar"),
    "true_divide": ("_npi_true_divide_scalar", "_npi_rtrue_divide_scalar"),
    "mod": ("_mod_scalar", "_rmod_scalar"),
    "remainder": ("_mod_scalar", "_rmod_scalar"),
    "power": ("_power_scalar", "_rpower_scalar"),
    "maximum": ("_maximum_scalar", "_maximum_scalar"),
    "minimum": ("_minimum_scalar", "_minimum_scalar"),
}


def _scalar_tensor(x, like):
    """A Python or numpy number as a 0-d tensor beside ``like``, in the
    type jnp's weak typing gives the pair."""
    dt = torch.result_type(like, x)
    return torch.full((), x, dtype=dt, device=like.device)


def _make_unary(name):
    op, fn = _UNARY[name]

    def f(x, out=None, **kwargs):
        if op is not None and not kwargs:
            return _op(op, [x], out=out)
        return _to_out(_invoke(lambda a: fn(a, **kwargs), [x],
                               "_np_" + name), out)

    f.__name__ = name
    return f


def _make_binary(name):
    op, fn = _BINARY[name]

    def f(x1, x2, out=None):
        t1, t2 = isinstance(x1, NDArray), isinstance(x2, NDArray)
        if not (t1 or t2):
            x1 = array(x1)
            t1 = True
        if op is not None and t1 and t2:
            return _op(op, [x1, x2], out=out)
        sop = _SCALAR_OPS.get(name)
        num = x2 if t1 else x1
        if sop is not None and isinstance(num, (int, float, _onp.number)) \
                and not isinstance(num, (bool, _onp.bool_)):
            # the number as Python's own type: an int keeps an integer
            # array's type, as jnp's weak typing does
            num = num.item() if isinstance(num, _onp.number) else num
            return _op(sop[0] if t1 else sop[1], [x1 if t1 else x2],
                       {"scalar": num}, out=out)
        if t1 and t2:
            res = _invoke(fn, [x1, x2], "_np_" + name)
        elif t1:
            res = _invoke(lambda a: fn(a, _scalar_tensor(x2, a)), [x1],
                          "_np_" + name)
        else:
            res = _invoke(lambda b: fn(_scalar_tensor(x1, b), b), [x2],
                          "_np_" + name)
        return _to_out(res, out)

    f.__name__ = name
    return f


for _n in _UNARY:
    globals()[_n] = _make_unary(_n)
for _n in _BINARY:
    globals()[_n] = _make_binary(_n)

abs = globals()["absolute"]  # noqa: A001
fix = globals()["trunc"]


def sigmoid(x):
    return _op("_npx_sigmoid", [x])


def relu(x):
    return _op("_npx_relu", [x])


def clip(a, a_min=None, a_max=None, out=None):
    return _op("clip", [a], {"a_min": a_min, "a_max": a_max}, out=out)


def round(a, decimals=0, out=None):  # noqa: A001
    return _op("_npi_around", [a], {"decimals": decimals}, out=out)


def around(x, decimals=0, out=None):
    return round(x, decimals, out=out)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    cond = condition if isinstance(condition, NDArray) else array(condition)
    return _op("_npi_where", [cond, x, y])


def nonzero(a):
    """The indices of the nonzero elements, one int32 array an axis (read
    on the host: the count depends on the data)."""
    idx = _op("_npx_nonzero", [a])
    return tuple(_invoke(lambda t: t.unbind(1), [idx], "_np_nonzero", None))


def maximum_(x1, x2):
    return globals()["maximum"](x1, x2)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _cast(a, dtype):
    a = a if isinstance(a, NDArray) else array(a)
    return a.astype(dtype) if dtype is not None and \
        to_torch_dtype(dtype) != to_torch_dtype(a.dtype) else a


def _make_reduce(name, op, has_dtype=True):
    def f(a, axis=None, dtype=None, keepdims=False, out=None, **kwargs):
        a = _cast(a, dtype if has_dtype else None)
        return _op(op, [a], {"axis": _axis(axis), "keepdims": keepdims},
                   out=out)

    f.__name__ = name
    return f


sum = _make_reduce("sum", "_np_sum")  # noqa: A001
mean = _make_reduce("mean", "_npi_mean")
prod = _make_reduce("prod", "_np_prod")
max = _make_reduce("max", "_np_max", has_dtype=False)  # noqa: A001
min = _make_reduce("min", "_np_min", has_dtype=False)  # noqa: A001
amax, amin = max, min
nansum = _make_reduce("nansum", "_npi_nansum")
nanprod = _make_reduce("nanprod", "_npi_nanprod")
all = _make_reduce("all", "_np_all", has_dtype=False)  # noqa: A001
any = _make_reduce("any", "_np_any", has_dtype=False)  # noqa: A001


def std(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return _op("_npi_std", [a], {"axis": _axis(axis), "ddof": ddof,
                                 "keepdims": keepdims})


def var(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return _op("_npi_var", [a], {"axis": _axis(axis), "ddof": ddof,
                                 "keepdims": keepdims})


def argmax(a, axis=None, out=None):
    return _op("_npi_argmax", [a], {"axis": axis}, out=out)


def argmin(a, axis=None, out=None):
    return _op("_npi_argmin", [a], {"axis": axis}, out=out)


def argsort(a, axis=-1):
    return _invoke(lambda x: torch.sort(x, dim=axis, stable=True)[1].to(
        torch.int32), [a], "_np_argsort")


def cumsum(a, axis=None, dtype=None):
    return _op("_np_cumsum", [_cast(a, dtype)], {"axis": axis})


def average(a, axis=None, weights=None):
    if weights is None:
        return mean(a, axis=axis)
    return _op("_npi_average", [a, weights], {"axis": _axis(axis)})[0]


def median(a, axis=None, keepdims=False):
    return _op("_npi_median", [a], {"axis": _axis(axis),
                                    "keepdims": keepdims})


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------

def reshape(a, newshape, order="C"):
    a = a if isinstance(a, ndarray) else _as_np(_arrs([a])[0])
    return a.reshape(newshape, order=order)


def transpose(a, axes=None):
    return _op("_np_transpose", [a], {"axes": axes})


def swapaxes(a, axis1, axis2):
    return _op("swapaxes", [a], {"dim1": axis1, "dim2": axis2})


def moveaxis(a, source, destination):
    return _op("_np_moveaxis", [a], {"source": source,
                                     "destination": destination})


def expand_dims(a, axis):
    return _op("expand_dims", [a], {"axis": axis})


def squeeze(a, axis=None):
    return _op("_np_squeeze", [a], {"axis": axis})


def broadcast_to(a, shape):
    return _op("_npi_broadcast_to", [a], {"shape": _shape(shape)})


def concatenate(seq, axis=0, out=None):
    return _op("_npi_concatenate", list(seq), {"axis": axis}, out=out)


def stack(arrays, axis=0, out=None):
    return _op("_npi_stack", list(arrays), {"axis": axis}, out=out)


def vstack(tup):
    return _op("_npi_vstack", list(tup))


def hstack(tup):
    return _op("_npi_hstack", list(tup))


def dstack(tup):
    return _op("_npi_dstack", list(tup))


def column_stack(tup):
    return _op("_npi_column_stack", list(tup))


def row_stack(tup):
    return vstack(tup)


def _split_points(n, indices_or_sections, even):
    if isinstance(indices_or_sections, int):
        k = indices_or_sections
        if even and n % k:
            raise ValueError("array split does not result in an equal "
                             "division")
        return k
    return [int(i) for i in indices_or_sections]


def split(ary, indices_or_sections, axis=0):
    a = _arrs([ary])[0]
    pts = _split_points(a.shape[axis], indices_or_sections, True)
    return _invoke(lambda x: torch.tensor_split(x, pts, dim=axis), [a],
                   "_np_split", None)


def array_split(ary, indices_or_sections, axis=0):
    a = _arrs([ary])[0]
    pts = _split_points(a.shape[axis], indices_or_sections, False)
    return _invoke(lambda x: torch.tensor_split(x, pts, dim=axis), [a],
                   "_np_array_split", None)


def hsplit(ary, indices_or_sections):
    a = _arrs([ary])[0]
    return split(a, indices_or_sections, axis=1 if a.ndim > 1 else 0)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=0)


def tile(a, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return _op("tile", [a], {"reps": reps})


def repeat(a, repeats, axis=None):
    return _op("repeat", [a], {"repeats": repeats, "axis": axis})


def flip(a, axis=None):
    return _op("_npi_flip", [a], {"axis": axis})


def fliplr(m):
    return flip(m, 1)


def flipud(m):
    return flip(m, 0)


def roll(a, shift, axis=None):
    return _op("_np_roll", [a], {"shift": shift, "axis": axis})


def rot90(a, k=1, axes=(0, 1)):
    return _op("_npi_rot90", [a], {"k": k, "axes": tuple(axes)})


def atleast_1d(*arys):
    outs = [_op("_np_atleast_1d", [a]) for a in arys]
    return outs[0] if len(outs) == 1 else outs


def pad(a, pad_width, mode="constant", constant_values=0):
    a = _arrs([a])[0]
    pw = _onp.broadcast_to(_onp.asarray(pad_width, dtype=_onp.int64),
                           (a.ndim, 2))
    return _op("pad", [a], {"mode": mode,
                            "pad_width": tuple(int(v) for v in pw.ravel()),
                            "constant_value": constant_values})


def diag(v, k=0):
    return _op("_np_diag", [v], {"k": k})


def tril(m, k=0):
    return _op("_npi_tril", [m], {"k": k})


def triu(m, k=0):
    return _invoke(lambda x: torch.triu(x, k), [m], "_np_triu")


def unique(ar, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    """Read on the host (the output's length depends on the data)."""
    res = _op("_npi_unique", [ar], {"return_index": return_index,
                                    "return_inverse": return_inverse,
                                    "return_counts": return_counts,
                                    "axis": axis})
    return tuple(res) if isinstance(res, list) else res


def ravel(x, order="C"):
    if order not in ("C", "K", "A"):
        raise MXNetError("ravel: only C-order is supported")
    return reshape(x, (-1,))


def resize(a, new_shape):
    """NumPy's ``resize``: the data repeated to fill ``new_shape``."""
    shape = _shape(new_shape)
    n = math.prod(shape)

    def fn(x):
        flat = x.reshape(-1)
        if flat.numel() == 0 or n == 0:
            return torch.zeros(shape, dtype=x.dtype, device=x.device)
        reps = -(-n // flat.numel())
        return flat.repeat(reps)[:n].reshape(shape)
    return _invoke(fn, [a], "_np_resize")


def append(arr, values, axis=None):
    def fn(a, v):
        if axis is None:
            return torch.cat([a.reshape(-1), v.reshape(-1).to(a.dtype)])
        return torch.cat([a, v.to(a.dtype)], axis)
    return _invoke(fn, [arr, values], "_np_append")


def empty_like(prototype, dtype=None, order="C"):
    p = _arrs([prototype])[0]
    return zeros(p.shape, dtype=dtype or p.dtype, ctx=p.context)


def broadcast_arrays(*args):
    return _invoke(lambda *xs: torch.broadcast_tensors(*xs), list(args),
                   "_np_broadcast_arrays", None)


def delete(arr, obj, axis=None):
    """Delete the entries at ``obj`` (an int, a slice, indices or a
    boolean mask, known at the call: the output's shape depends on it)."""
    from ..graph_cache import refuse_host_read

    a = _arrs([arr])[0]
    refuse_host_read("delete", a._data)
    if isinstance(obj, NDArray):
        obj = obj.asnumpy()
    elif isinstance(obj, (list, tuple)):
        obj = _onp.asarray(obj)
    if isinstance(obj, _onp.ndarray) and obj.dtype != _onp.bool_:
        obj = obj.astype(_onp.int64)
    n = a.size if axis is None else a.shape[axis]
    keep = _onp.delete(_onp.arange(n), obj)

    def fn(x):
        src = x.reshape(-1) if axis is None else x
        idx = torch.as_tensor(keep, dtype=torch.int64, device=x.device)
        return torch.index_select(src, 0 if axis is None else axis, idx)
    return _invoke(fn, [a], "_np_delete")


def indices(dimensions, dtype=None):
    return _make("_npi_indices", {"dimensions": tuple(dimensions),
                                  "dtype": dtype or "int32"}, None)


def unravel_index(idx, shape, order="C"):
    if order != "C":
        raise MXNetError("unravel_index: only C-order is supported")
    shape = _shape(shape)

    def fn(i):
        i = i.to(torch.int64)
        out = []
        for d in reversed(shape):
            out.append(torch.remainder(i, d).to(torch.int32))
            i = torch.div(i, d, rounding_mode="floor")
        return tuple(reversed(out))
    return tuple(_invoke(fn, [idx], "_np_unravel_index", None))


# ---------------------------------------------------------------------------
# linear algebra at the top level
# ---------------------------------------------------------------------------

def dot(a, b, out=None):
    return _op("_np_dot", [a, b], out=out)


def matmul(a, b):
    return _invoke(torch.matmul, [a, b], "_np_matmul")


def tensordot(a, b, axes=2):
    if isinstance(axes, int):
        return _op("_npi_tensordot_int_axes", [a, b], {"axes": axes})
    a_ax, b_ax = axes
    a_ax = (a_ax,) if isinstance(a_ax, int) else tuple(a_ax)
    b_ax = (b_ax,) if isinstance(b_ax, int) else tuple(b_ax)
    return _op("_npi_tensordot", [a, b], {"a_axes_summed": a_ax,
                                          "b_axes_summed": b_ax})


def inner(a, b):
    return _invoke(torch.inner, [a, b], "_np_inner")


def outer(a, b):
    return _invoke(lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)),
                   [a, b], "_np_outer")


def einsum(subscripts, *operands):
    return _op("_npi_einsum", list(operands), {"subscripts": subscripts})


def trace(a, offset=0, axis1=0, axis2=1):
    return _op("_np_trace", [a], {"offset": offset, "axis1": axis1,
                                  "axis2": axis2})


def kron(a, b):
    return _invoke(torch.kron, [a, b], "_np_kron")


def vdot(a, b):
    return _invoke(lambda x, y: torch.dot(x.reshape(-1), y.reshape(-1)),
                   [a, b], "_np_vdot")


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def shape(a):
    return a.shape if isinstance(a, NDArray) else _onp.shape(a)


def ndim(a):
    return a.ndim if isinstance(a, NDArray) else _onp.ndim(a)


def size(a):
    return a.size if isinstance(a, NDArray) else _onp.size(a)


def _host(a):
    return a.asnumpy() if isinstance(a, NDArray) else _onp.asarray(a)


def array_equal(a1, a2):
    return builtins.bool(_onp.array_equal(_host(a1), _host(a2)))


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return builtins.bool(_onp.allclose(_host(a), _host(b), rtol, atol,
                                       equal_nan))


def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return _invoke(lambda x, y: torch.isclose(
        *torch.broadcast_tensors(*(_flt(t) for t in (x, y))), rtol, atol,
        equal_nan), [a, b], "_np_isclose")


def one_hot(indices, depth, dtype="float32"):
    dt = to_torch_dtype(dtype)
    return _invoke(lambda i: (i.to(torch.int64).unsqueeze(-1) == torch.arange(
        depth, device=i.device)).to(dt), [indices], "_np_one_hot")


def searchsorted(a, v, side="left"):
    return _invoke(lambda x, q: torch.searchsorted(
        x, q, right=side == "right").to(torch.int32), [a, v],
        "_np_searchsorted")


def bincount(x, weights=None, minlength=0):
    """Read on the host (the output's length is the data's maximum)."""
    ins = [x] if weights is None else [x, weights]
    return _op("_npi_bincount", ins, {"minlength": minlength})


def interp(x, xp, fp):
    """Linear interpolation, ``fp[0]``/``fp[-1]`` outside ``xp``."""
    def fn(q, px, py):
        q, px, py = _flt(q), _flt(px), _flt(py)
        i = torch.searchsorted(px, q, right=True).clamp(1, px.shape[0] - 1)
        x0, x1 = px[i - 1], px[i]
        y0, y1 = py[i - 1], py[i]
        dx = x1 - x0
        t = torch.where(dx == 0, torch.zeros_like(q), (q - x0) / dx)
        out = y0 + t * (y1 - y0)
        out = torch.where(q < px[0], py[0], out)
        return torch.where(q > px[-1], py[-1], out)
    return _invoke(fn, [x, xp, fp], "_np_interp")


def diff(a, n=1, axis=-1):
    return _op("_npi_diff", [a], {"n": n, "axis": axis})


def cross(a, b, axis=-1):
    return _op("_npi_cross", [a, b], {"axis": axis})


def cumprod(a, axis=None):
    return _invoke(lambda x: torch.cumprod(
        x.reshape(-1) if axis is None else x, 0 if axis is None else axis),
        [a], "_np_cumprod")


def gradient(f, *varargs, axis=None):
    def fn(x):
        kw = {"dim": axis} if axis is not None else {}
        if varargs:
            kw["spacing"] = list(varargs)
        return tuple(torch.gradient(_flt(x), **kw))
    outs = _invoke(fn, [f], "_np_gradient", None)
    return outs[0] if len(outs) == 1 else tuple(outs)


def take(a, indices, axis=None, mode="clip"):
    a = _arrs([a])[0]
    if axis is None:
        a, axis = a.reshape((-1,)), 0
    idx = indices if isinstance(indices, NDArray) else array(
        _onp.asarray(indices), dtype="int32", ctx=a.context)
    return _op("take", [a, idx], {"axis": axis, "mode": mode})


# ---------------------------------------------------------------------------
# statistics, windows, sets (reference: numpy/multiarray.py and
# src/operator/numpy/np_percentile_op.cc, np_window_op.cc, the set ops)
# ---------------------------------------------------------------------------


def percentile(a, q, axis=None, interpolation="linear", keepdims=False):
    return _op("_npi_percentile", [a], {"q": q, "axis": _axis(axis),
                                        "interpolation": interpolation,
                                        "keepdims": keepdims})


def quantile(a, q, axis=None, interpolation="linear", keepdims=False):
    return _op("_npi_quantile", [a], {"q": q, "axis": _axis(axis),
                                      "interpolation": interpolation,
                                      "keepdims": keepdims})


def histogram(a, bins=10, range=None):  # noqa: A002
    """``(counts, edges)``, f32 both, as ``jnp.histogram`` gives them:
    ``bins`` a count (over ``range`` or the data's span) or the edges
    themselves."""
    if isinstance(bins, int):
        counts, edges = _op("_npi_histogram", [a], {"bin_cnt": bins,
                                                    "range": range})
        return counts.astype("float32"), edges

    def fn(x, edges):
        x, edges = _flt(x).reshape(-1), _flt(edges)
        idx = torch.searchsorted(edges, x, right=True)
        idx = torch.where(x == edges[-1], edges.shape[0] - 1, idx)
        counts = torch.zeros(edges.shape[0] + 1, dtype=torch.float32,
                             device=x.device)
        counts = counts.index_add(0, idx, torch.ones_like(x))
        return counts[1:edges.shape[0]], edges
    return tuple(_invoke(fn, [a, bins], "_np_histogram", None))


def cov(m, y=None, rowvar=True, bias=False, ddof=None):
    if y is not None:
        m = _invoke(lambda p, q: torch.cat(
            [torch.atleast_2d(p) if rowvar else torch.atleast_2d(p.T).T,
             torch.atleast_2d(q) if rowvar else torch.atleast_2d(q.T).T],
            0 if rowvar else 1), [m, y], "_np_cov_stack")
    return _op("_npi_cov", [m], {"rowvar": rowvar, "bias": bias,
                                 "ddof": ddof})


def corrcoef(x, rowvar=True):
    return _op("_npi_corrcoef", [x], {"rowvar": rowvar})


def ptp(a, axis=None, keepdims=False):
    return _op("_npi_ptp", [a], {"axis": _axis(axis), "keepdims": keepdims})


def _nan_reduce(name, with_ddof=False):
    def f(a, axis=None, ddof=0, keepdims=False):
        attrs = {"axis": _axis(axis), "keepdims": keepdims}
        if with_ddof:
            attrs["ddof"] = ddof
        return _op("_npi_" + name, [a], attrs)
    f.__name__ = name
    return f


nanmean = _nan_reduce("nanmean")
nanstd = _nan_reduce("nanstd", with_ddof=True)
nanvar = _nan_reduce("nanvar", with_ddof=True)


def nanmax(a, axis=None, keepdims=False):
    return _op("_npi_nanmax", [a], {"axis": _axis(axis),
                                    "keepdims": keepdims})


def nanmin(a, axis=None, keepdims=False):
    return _op("_npi_nanmin", [a], {"axis": _axis(axis),
                                    "keepdims": keepdims})


def nanargmax(a, axis=None):
    return _op("_npi_nanargmax", [a], {"axis": axis})


def nanargmin(a, axis=None):
    return _op("_npi_nanargmin", [a], {"axis": axis})


def _window(name):
    def f(M, dtype="float32", ctx=None):
        return _make("_npi_" + name, {"M": M, "dtype": dtype}, ctx)
    f.__name__ = name
    return f


hanning = _window("hanning")
hamming = _window("hamming")
blackman = _window("blackman")
bartlett = _window("bartlett")


def polyval(p, x):
    return _op("_npi_polyval", [p, x])


def ediff1d(ary, to_end=None, to_begin=None):
    a = _arrs([ary])[0]
    ins, fields = [a], ["data"]
    for name, v in (("to_end", to_end), ("to_begin", to_begin)):
        if v is not None:
            ins.append(v if isinstance(v, NDArray) else array(
                _onp.atleast_1d(v), ctx=a.context))
            fields.append(name)
    return _as_np(_reg.invoke("_npi_ediff1d", ins, {},
                              fields=tuple(fields)))


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    was = isinstance(x, NDArray)
    x = _arrs([x])[0]
    res = _op("_npi_nan_to_num", [x], {"nan": nan, "posinf": posinf,
                                       "neginf": neginf})
    if not copy and was:
        x._adopt(res)
        return x
    return res


def digitize(x, bins, right=False):
    return _op("_npi_digitize", [x, bins], {"right": right})


def trapz(y, x=None, dx=1.0, axis=-1):
    if x is None:
        return _op("_npi_trapz", [y], {"dx": dx, "axis": axis})
    return _op("_npi_trapz", [y, x], {"axis": axis})


def isin(element, test_elements, assume_unique=False, invert=False):
    return _op("_npi_isin", [element, test_elements], {"invert": invert})


def in1d(ar1, ar2, assume_unique=False, invert=False):
    return isin(ar1, ar2, assume_unique=assume_unique,
                invert=invert).reshape(-1)


def _set_op(name):
    def f(ar1, ar2, assume_unique=False):
        return _op("_npi_" + name, [ar1, ar2],
                   {"assume_unique": assume_unique})
    f.__name__ = name
    return f


intersect1d = _set_op("intersect1d")
union1d = _set_op("union1d")
setdiff1d = _set_op("setdiff1d")
setxor1d = _set_op("setxor1d")


def ldexp(x1, x2):
    return _op("_npi_ldexp", [x1, x2])


def _check_bitwise_dtype(fn_name, *arrs):
    for a in arrs:
        dt = a.dtype if isinstance(a, NDArray) else _onp.asarray(a).dtype
        if _onp.dtype(dt).kind == "f":
            raise TypeError(
                "%s not supported for float input (dtype %s): bitwise ops "
                "take integer or bool operands" % (fn_name, dt))


def bitwise_not(x):
    _check_bitwise_dtype("bitwise_not", x)
    return _op("_npi_bitwise_not", [x])


invert = bitwise_not


def bitwise_or(x1, x2):
    _check_bitwise_dtype("bitwise_or", x1, x2)
    return _op("_npi_bitwise_or", [x1, x2])


def bitwise_xor(x1, x2):
    _check_bitwise_dtype("bitwise_xor", x1, x2)
    return _op("_npi_bitwise_xor", [x1, x2])


def shares_memory(a, b, max_work=None):
    """Whether the two arrays are views of one storage."""
    if a is b:
        return True
    if not (isinstance(a, NDArray) and isinstance(b, NDArray)):
        return False
    sa, sb = a._data.untyped_storage(), b._data.untyped_storage()
    return sa.data_ptr() == sb.data_ptr() and sa.nbytes() > 0


may_share_memory = shares_memory


def genfromtxt(*args, **kwargs):
    """Host-side text loader (numpy's, wrapped)."""
    return array(_onp.genfromtxt(*args, **kwargs))


def set_printoptions(*args, **kwargs):
    """Printing is numpy's formatting of a host copy."""
    _onp.set_printoptions(*args, **kwargs)


from . import linalg  # noqa: E402,F401
from . import random  # noqa: E402,F401
