"""Tensor operators: elementwise, broadcast, scalar, unary, reductions,
shape manipulation, creation, indexing, ordering, the sequence ops,
``dot``, ``batch_dot``, ``einsum`` and the ``_linalg_*`` family.

The port's counterpart of the JAX package's ``ops/tensor.py``, op for op
in PyTorch, with the same names, attrs and MXNet semantics where they
differ from NumPy's: ``sum``/``mean``/... take ``axis=()`` for all axes
and ``exclude`` to invert the axis set; ``elemwise_*`` want equal shapes
and ``broadcast_*`` broadcast; ``reshape`` takes the codes 0/-1/-2/-3/-4;
comparisons return the input's dtype; ``argmax``/``argmin``,
``argsort`` and ``topk``'s indices return float32 by default.

``sort``, ``argsort`` and ``topk`` run on torch's stable sort, so ties
come out as the JAX package's do: ``topk`` takes the lower index first
among equal values (``lax.top_k``), and a descending ``sort`` or
``argsort`` is the ascending one reversed (ties in reverse index
order).  The scatter ops send an index out of range to a spare row that
is dropped, as XLA's scatter drops it.  The ``_linalg_*`` ops run on
``torch.linalg`` (cuSOLVER and cuBLAS on the card).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import amp as _amp
from .registry import alias, register

_DTYPES = {
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def to_torch_dtype(dtype):
    """A torch dtype from a name, a numpy dtype or type, or a torch
    dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError("unsupported dtype %r" % (dtype,)) from None


def _float_of(x):
    """``x`` itself when floating, else in float32 (jnp's default for
    the float-valued functions of integer input)."""
    return x if x.is_floating_point() else x.to(torch.float32)


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------


def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        axes = tuple(range(ndim))
    elif isinstance(axis, (tuple, list)):
        axes = tuple(a % ndim for a in axis) if axis else tuple(range(ndim))
    else:
        axes = (int(axis) % ndim,)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, d, keepdim=keepdim)
    return x


_REDUCERS = {
    "sum": lambda x, dim, keepdim: torch.sum(x, dim, keepdim=keepdim),
    "mean": lambda x, dim, keepdim: torch.mean(_float_of(x), dim,
                                               keepdim=keepdim),
    "prod": _prod,
    "max": lambda x, dim, keepdim: torch.amax(x, dim, keepdim=keepdim),
    "min": lambda x, dim, keepdim: torch.amin(x, dim, keepdim=keepdim),
    "nansum": lambda x, dim, keepdim: torch.nansum(x, dim, keepdim=keepdim),
    "nanprod": lambda x, dim, keepdim: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), dim, keepdim),
}


# what jnp (64-bit types off) sums and multiplies integers and booleans
# into: 32 bits, unsigned from unsigned; 64-bit arrays stay 64-bit, as
# MXNet keeps them
_INT_ACCUM = {torch.bool: torch.int32, torch.int8: torch.int32,
              torch.int16: torch.int32, torch.int32: torch.int32,
              torch.uint8: torch.uint32, torch.uint16: torch.uint32,
              torch.uint32: torch.uint32}


def _int_accum(out, x, running=False):
    """``out`` (torch's int64 sum, product or, ``running``, running sum
    of ``x``) in the type jnp gives it: the same low bits, as a sum that
    wraps in that type gives them.  jnp's running sum keeps an integer
    input's own type and counts booleans in int32."""
    if running:
        dt = torch.int32 if x.dtype == torch.bool \
            else x.dtype if x.dtype in _INT_ACCUM else None
    else:
        dt = _INT_ACCUM.get(x.dtype)
    return out if dt is None or out.dtype == dt else out.to(dt)


def _reduce(fn_name):
    red = _REDUCERS[fn_name]
    accum = fn_name in ("sum", "prod", "nansum", "nanprod")

    def op(x, axis=None, keepdims=False, exclude=False):
        axes = _norm_axis(axis, x.dim(), exclude)
        out = red(x, axes, bool(keepdims)) if axes else x.clone()
        return _int_accum(out, x) if accum else out

    return op


def _scalar(x, scalar):
    """``scalar`` as a 0-d tensor of the promoted type, beside ``x``."""
    dt = torch.result_type(x, scalar)
    # a fill, not a host copy: a captured graph may hold it
    return x.to(dt), torch.full((), scalar, dtype=dt, device=x.device)


# ----------------------------------------------------------------------------
# elementwise binary (same-shape) + scalar + broadcast variants
# ----------------------------------------------------------------------------


def _cmp(f):
    return lambda a, b: f(a, b).to(a.dtype)


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "mod": torch.remainder,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": lambda a, b: torch.hypot(_float_of(a), _float_of(b)),
    "equal": _cmp(torch.eq),
    "not_equal": _cmp(torch.ne),
    "greater": _cmp(torch.gt),
    "greater_equal": _cmp(torch.ge),
    "lesser": _cmp(torch.lt),
    "lesser_equal": _cmp(torch.le),
    "logical_and": _cmp(torch.logical_and),
    "logical_or": _cmp(torch.logical_or),
    "logical_xor": _cmp(torch.logical_xor),
}


def _same_shape(f, name):
    def op(lhs, rhs):
        if lhs.shape != rhs.shape:
            raise ValueError("%s wants equal shapes, got %s and %s (use "
                             "broadcast_%s)" % (name, tuple(lhs.shape),
                                                tuple(rhs.shape),
                                                name.split("_", 1)[-1]))
        return f(lhs, rhs)

    return op


for _name, _fn in _BINARY.items():
    # elemwise_* (same shape) — internal names match reference (_plus etc.)
    _ew_name = {
        "add": "elemwise_add", "sub": "elemwise_sub", "mul": "elemwise_mul",
        "div": "elemwise_div",
    }.get(_name, "_" + _name)
    register(_ew_name, aliases=("_" + _name,) if _ew_name != "_" + _name
             else ())(_same_shape(_fn, _ew_name))
    register("broadcast_" + _name)(
        (lambda f: lambda lhs, rhs: f(lhs, rhs))(_fn))

alias("broadcast_plus", "broadcast_add")
alias("broadcast_minus", "broadcast_sub")


def _scalar_op(f, reverse=False):
    def op(x, scalar):
        x, s = _scalar(x, scalar)
        return f(s, x) if reverse else f(x, s)

    return op


def _true_div_args(x, scalar):
    """``(x, scalar)`` with ``x`` in the true division's type (an integer
    or boolean ``x`` becomes float, as torch's ``x / scalar`` makes it):
    ``_div``/``_rdiv`` then divide as the JAX package does, truly, where
    torch's ``x / scalar`` on the card and ``scalar / x`` anywhere
    multiply by a reciprocal."""
    dt = torch.result_type(x, scalar)
    if not dt.is_floating_point and not dt.is_complex:
        dt = torch.get_default_dtype()
    return x.to(dt), scalar


_SCALAR_BINARY = {
    "_plus_scalar": lambda x, scalar: x + scalar,
    "_minus_scalar": lambda x, scalar: x - scalar,
    "_rminus_scalar": lambda x, scalar: scalar - x,
    "_mul_scalar": lambda x, scalar: x * scalar,
    "_div_scalar": lambda x, scalar: _div(*_true_div_args(x, scalar)),
    "_rdiv_scalar": lambda x, scalar: _rdiv(
        *_true_div_args(x, scalar)[::-1]),
    "_mod_scalar": _scalar_op(torch.remainder),
    "_rmod_scalar": _scalar_op(torch.remainder, reverse=True),
    "_power_scalar": lambda x, scalar: torch.pow(x, scalar),
    "_rpower_scalar": _scalar_op(torch.pow, reverse=True),
    "_maximum_scalar": _scalar_op(torch.maximum),
    "_minimum_scalar": _scalar_op(torch.minimum),
    "_equal_scalar": lambda x, scalar: (x == scalar).to(x.dtype),
    "_not_equal_scalar": lambda x, scalar: (x != scalar).to(x.dtype),
    "_greater_scalar": lambda x, scalar: (x > scalar).to(x.dtype),
    "_greater_equal_scalar": lambda x, scalar: (x >= scalar).to(x.dtype),
    "_lesser_scalar": lambda x, scalar: (x < scalar).to(x.dtype),
    "_lesser_equal_scalar": lambda x, scalar: (x <= scalar).to(x.dtype),
    "_logical_and_scalar": lambda x, scalar: torch.logical_and(
        x, torch.tensor(bool(scalar))).to(x.dtype),
    "_logical_or_scalar": lambda x, scalar: torch.logical_or(
        x, torch.tensor(bool(scalar))).to(x.dtype),
    "_logical_xor_scalar": lambda x, scalar: torch.logical_xor(
        x, torch.tensor(bool(scalar))).to(x.dtype),
}
for _name, _fn in _SCALAR_BINARY.items():
    # inputs declared explicitly: ``scalar`` is a static attr, not a tensor
    register(_name, inputs=("x",))(_fn)

# ----------------------------------------------------------------------------
# elementwise unary
# ----------------------------------------------------------------------------


def _cbrt(x):
    x = _float_of(x)
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _f(fn):
    """A float-valued function of ``x``, in float32 for integer input."""
    return lambda x: fn(_float_of(x))


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "ceil": torch.ceil,
    "floor": torch.floor, "rint": torch.round, "round": torch.round,
    "trunc": torch.trunc, "fix": torch.trunc,
    "exp": _f(torch.exp), "log": _f(torch.log), "log2": _f(torch.log2),
    "log10": _f(torch.log10), "log1p": _f(torch.log1p),
    "expm1": _f(torch.expm1), "sqrt": _f(torch.sqrt),
    "rsqrt": _f(torch.rsqrt), "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x), "square": torch.square,
    "reciprocal": lambda x: 1.0 / x, "negative": torch.negative,
    "sin": _f(torch.sin), "cos": _f(torch.cos), "tan": _f(torch.tan),
    "arcsin": _f(torch.asin), "arccos": _f(torch.acos),
    "arctan": _f(torch.atan), "sinh": _f(torch.sinh),
    "cosh": _f(torch.cosh), "tanh": _f(torch.tanh),
    "arcsinh": _f(torch.asinh), "arccosh": _f(torch.acosh),
    "arctanh": _f(torch.atanh),
    "degrees": _f(torch.rad2deg), "radians": _f(torch.deg2rad),
    "sigmoid": _f(torch.sigmoid),
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "relu": torch.relu, "erf": _f(torch.erf), "erfinv": _f(torch.erfinv),
    "gamma": lambda x: torch.exp(torch.lgamma(_float_of(x))),
    "gammaln": _f(torch.lgamma),
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
}
for _name, _fn in _UNARY.items():
    register(_name)((lambda f: lambda data: f(data))(_fn))

alias("_copy", "identity")
register("identity")(lambda data: data.clone())
register("stop_gradient", aliases=("BlockGrad", "make_loss_grad_stop"))(
    lambda data: data.detach())
register("make_loss")(lambda data: data.clone())


def _div(t, c):
    """``t / c`` as one true division by the constant, in ``t``'s dtype
    (on the card, a tensor over a host scalar is the product by the
    scalar's reciprocal)."""
    return t / t.new_full((), c)


def _rdiv(c, t):
    """``c / t`` as one true division of the constant by ``t`` (torch's
    ``c / t`` is ``reciprocal(t) * c``)."""
    return t.new_full((), c) / t


def _index_dtype():
    """int64 under ``MXNET_INT64_TENSOR_SIZE=1`` (the JAX package turns
    on x64 for it), int32 otherwise."""
    wide = os.environ.get("MXNET_INT64_TENSOR_SIZE", "0") in ("1", "true")
    return torch.int64 if wide else torch.int32


def _filled(values, dtype, device):
    """A 1-d tensor of ``values`` made by fills on ``device`` (no host
    copy: a captured graph may hold it)."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values]) if values else \
        torch.zeros((0,), dtype=dtype, device=device)


@register("shape_array")
def _shape_array(data):
    """Parity: shape_array: the shape as a 1-d integer tensor."""
    return _filled(list(data.shape), _index_dtype(), data.device)


@register("size_array")
def _size_array(data):
    """Parity: size_array: the number of elements as a (1,) tensor."""
    return _filled([data.numel()], _index_dtype(), data.device)

# ----------------------------------------------------------------------------
# casts
# ----------------------------------------------------------------------------


@register("cast", aliases=("Cast",))
def _cast(data, dtype="float32"):
    return data.to(to_torch_dtype(dtype))


@register("amp_cast")
def _amp_cast(data, dtype="float16"):
    """Parity: amp_cast: a cast AMP puts into a graph."""
    return data.to(to_torch_dtype(dtype))


@register("amp_multicast")
def _amp_multicast(*data, num_outputs=1):
    """Parity: amp_multicast: every input cast to the widest of their
    dtypes (the promoted type, as ``jnp.result_type`` gives it)."""
    widest = data[0].dtype
    for d in data[1:]:
        widest = torch.promote_types(widest, d.dtype)
    return tuple(d.to(widest) for d in data)


# ----------------------------------------------------------------------------
# reductions
# ----------------------------------------------------------------------------

for _name in ("sum", "mean", "prod", "max", "min", "nansum", "nanprod"):
    register(_name, aliases=("sum_axis",) if _name == "sum" else ())(
        _reduce(_name))


@register("norm")
def _norm(data, ord=2, axis=None, keepdims=False):
    axes = _norm_axis(axis, data.dim())
    if ord == 1:
        return torch.sum(torch.abs(data), axes, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), axes, keepdim=keepdims))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1), 0)
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = fn(data, int(axis), keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmax")
def _argmax(data, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def _argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel")
def _argmax_channel(data):
    return torch.argmax(data, -1).to(torch.float32)


@register("cumsum")
def _cumsum(a, axis=None, dtype=None):
    if axis is None:
        a, axis = a.reshape(-1), 0
    if dtype is not None:
        return torch.cumsum(a, int(axis), dtype=to_torch_dtype(dtype))
    return _int_accum(torch.cumsum(a, int(axis)), a, running=True)


@register("logsumexp")
def _logsumexp(data, axis=None, keepdims=False):
    axes = _norm_axis(axis, data.dim())
    return torch.logsumexp(_float_of(data), axes, keepdim=keepdims)


# ----------------------------------------------------------------------------
# shape manipulation
# ----------------------------------------------------------------------------


def _infer_reshape(src_shape, target):
    """MXNet Reshape magic codes 0/-1/-2/-3/-4 (reference matrix_op-inl.h)."""
    out = []
    src = list(src_shape)
    i = 0  # index into src
    t = 0
    target = list(target)
    while t < len(target):
        d = target[t]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)  # placeholder, fixed below
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            d1, d2 = target[t + 1], target[t + 2]
            cur = src[i]
            i += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            t += 2
        else:
            out.append(d)
            i += 1 if i < len(src) else 0
        t += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in src_shape:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("reshape", aliases=("Reshape",))
def _reshape(data, shape=None, reverse=False):
    return torch.reshape(data, _infer_reshape(data.shape, shape))


@register("reshape_like")
def _reshape_like(lhs, rhs):
    return torch.reshape(lhs, rhs.shape)


@register("flatten", aliases=("Flatten",))
def _flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("transpose")
def _transpose(data, axes=None):
    if axes is None or axes == ():
        axes = tuple(reversed(range(data.dim())))
    return data.permute(tuple(axes))


@register("swapaxes", aliases=("SwapAxis",))
def _swapaxes(data, dim1=0, dim2=0):
    return torch.swapaxes(data, dim1, dim2)


@register("expand_dims")
def _expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@register("squeeze")
def _squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    axes = _norm_axis(axis, data.dim())
    for a in axes:
        if data.shape[a] != 1:
            raise ValueError("cannot squeeze axis %d of size %d"
                             % (a, data.shape[a]))
    return torch.squeeze(data, axes)


@register("depth_to_space")
def _depth_to_space(data, block_size=2):
    n, c, h, w = data.shape
    b = block_size
    x = torch.reshape(data, (n, b, b, c // (b * b), h, w))
    x = x.permute(0, 3, 4, 1, 5, 2)
    return torch.reshape(x, (n, c // (b * b), h * b, w * b))


@register("space_to_depth")
def _space_to_depth(data, block_size=2):
    n, c, h, w = data.shape
    b = block_size
    x = torch.reshape(data, (n, c, h // b, b, w // b, b))
    x = x.permute(0, 3, 5, 1, 2, 4)
    return torch.reshape(x, (n, c * b * b, h // b, w // b))


@register("broadcast_to")
def _broadcast_to(data, shape=None):
    tgt = tuple(s if t == 0 else t for s, t in zip(data.shape, shape))
    return data.expand(tgt).contiguous()


@register("broadcast_like")
def _broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape).contiguous()


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(data, axis=(), size=()):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    sizes = size if isinstance(size, (tuple, list)) else (size,)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return data.expand(tuple(tgt)).contiguous()


@register("tile")
def _tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat")
def _repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("reverse", aliases=("flip",))
def _reverse(data, axis=()):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return torch.flip(data, tuple(axes))


@register("concat", aliases=("Concat",))
def _concat(*data, dim=1, num_args=None):
    return torch.cat(data, dim)


@register("stack")
def _stack(*data, axis=0, num_args=None):
    return torch.stack(data, axis)


def _squeezed(parts, axis, squeeze_axis):
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(p.contiguous() for p in parts)


@register("split", aliases=("SliceChannel",))
def _split(data, num_outputs=1, axis=1, squeeze_axis=False):
    if data.shape[axis] % num_outputs:
        raise ValueError("split: axis %d of size %d does not divide into "
                         "%d parts" % (axis, data.shape[axis], num_outputs))
    parts = torch.split(data, data.shape[axis] // num_outputs, axis)
    return _squeezed(parts, axis, squeeze_axis)


@register("split_v2")
def _split_v2(data, indices=(), axis=0, squeeze_axis=False, sections=0):
    if sections:
        return _split(data, sections, axis, squeeze_axis)
    parts = torch.tensor_split(data, list(indices), axis)
    return _squeezed(parts, axis, squeeze_axis)


def _slice_dim(x, dim, sl):
    """``x`` cut along ``dim`` by a Python slice, negative steps too."""
    if sl.step is None or sl.step > 0:
        return x[(slice(None),) * dim + (sl,)]
    idx = torch.arange(*sl.indices(x.shape[dim]), device=x.device)
    return torch.index_select(x, dim, idx)


@register("slice")
def _slice(data, begin=(), end=(), step=()):
    step = step or (None,) * len(begin)
    out = data
    for i, (b, e) in enumerate(zip(begin, end)):
        s = step[i] if i < len(step) else None
        out = _slice_dim(out, i, slice(b, e, s))
    return out.contiguous()


@register("slice_axis")
def _slice_axis(data, axis=0, begin=0, end=None):
    return _slice_dim(data, axis % data.dim(),
                      slice(begin, end)).contiguous()


@register("slice_like")
def _slice_like(data, shape_like, axes=()):
    axes = axes if axes else tuple(range(min(data.dim(), shape_like.dim())))
    out = data
    for a in axes:
        out = out.narrow(a, 0, min(shape_like.shape[a], out.shape[a]))
    return out.contiguous()


def _pad_index(n, lo, hi, mode, device):
    """Source index of each padded position along one axis: ``edge``,
    ``reflect`` (the edge not repeated), and for ``mx.np.pad`` numpy's
    ``wrap`` and ``symmetric`` (the edge repeated)."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return pos.clamp(0, n - 1)
    if mode == "wrap":
        return pos % n
    if mode == "symmetric":
        pos = pos % (2 * n)
        return torch.where(pos >= n, 2 * n - 1 - pos, pos)
    period = 2 * (n - 1)
    pos = pos.abs() % period if period else torch.zeros_like(pos)
    return torch.where(pos >= n, period - pos, pos)


@register("pad", aliases=("Pad",))
def _pad(data, mode="constant", pad_width=(), constant_value=0.0):
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pw):
            flat += [lo, hi]
        return torch.nn.functional.pad(data, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("pad mode %r (constant, edge or reflect)" % mode)
    out = data
    for dim, (lo, hi) in enumerate(pw):
        if lo or hi:
            out = torch.index_select(out, dim, _pad_index(
                out.shape[dim], lo, hi, mode, out.device))
    return out


@register("clip")
def _clip(data, a_min=None, a_max=None):
    return torch.clamp(data, a_min, a_max)


@register("where")
def _where(condition, x, y):
    """Parity: where: ``x`` where ``condition`` is non-zero, else ``y``
    (under AMP both in the wider of their dtypes)."""
    x, y = _amp.transform_inputs("where", (x, y))
    return torch.where(condition.bool(), x, y)


@register("boolean_mask_fill")
def _boolean_mask_fill(data, mask, value=0.0):
    """Parity: boolean_mask_fill, the JAX package's static-shape stand-in
    for boolean_mask: ``data`` where ``mask`` (over the leading axes) is
    non-zero, ``value`` elsewhere."""
    m = mask.bool().reshape(mask.shape + (1,) * (data.dim() - mask.dim()))
    return torch.where(m, data, torch.full((), value, dtype=data.dtype,
                                           device=data.device))


@register("one_hot")
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """Parity: one_hot: ``on_value`` at each index along a new last axis
    of size ``depth`` (an index out of range gives a row of
    ``off_value``), ``off_value`` elsewhere."""
    idx = indices.long()
    hot = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device))
    dt = to_torch_dtype(dtype)
    return hot.to(dt) * (on_value - off_value) + off_value


# ----------------------------------------------------------------------------
# indexing
# ----------------------------------------------------------------------------


@register("take")
def _take(a, indices, axis=0, mode="clip"):
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = indices.to(torch.int32).to(torch.int64)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    idx = index.to(torch.int32).to(torch.int64).clamp(0, data.shape[axis] - 1)
    out = torch.take_along_dim(data, torch.unsqueeze(idx, axis), axis)
    return out if keepdims else torch.squeeze(out, axis)


def _nd_index(indices, shape):
    """The (M, ...) integer ``indices`` into the leading M axes of
    ``shape``, negative ones counted from the end: the flat index into
    those axes, and whether each is in range."""
    idx = indices.to(torch.int32).long()
    m = idx.shape[0]
    flat = torch.zeros(idx.shape[1:], dtype=torch.long, device=idx.device)
    ok = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    for i in range(m):
        n = shape[i]
        j = torch.where(idx[i] < 0, idx[i] + n, idx[i])
        ok = ok & (j >= 0) & (j < n)
        flat = flat * n + j.clamp(0, max(n - 1, 0))
    return flat, ok, int(np.prod(shape[:m], dtype=np.int64))


@register("gather_nd")
def _gather_nd(data, indices):
    """Parity: gather_nd: ``data[indices[0], ..., indices[M-1]]``; an
    index out of range is clamped, as an XLA gather clamps it."""
    flat, _, rows = _nd_index(indices, data.shape)
    m = indices.shape[0]
    src = data.reshape((rows,) + tuple(data.shape[m:]))
    out = torch.index_select(src, 0, flat.reshape(-1))
    return out.reshape(tuple(flat.shape) + tuple(data.shape[m:]))


def _scatter_into(base, flat, ok, rows, values):
    """``base`` (rows, ...) with ``values`` written at ``flat``; the
    writes out of range go to a spare last row, then dropped."""
    tail = tuple(base.shape[1:])
    spare = torch.cat([base, base.new_zeros((1,) + tail)])
    dest = torch.where(ok, flat, torch.full_like(flat, rows))
    vals = values.expand(tuple(flat.shape) + tail).reshape((-1,) + tail)
    return spare.index_put((dest.reshape(-1),), vals.to(base.dtype))[:rows]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=()):
    """Parity: scatter_nd: zeros of ``shape`` with ``data`` written at
    ``indices`` (duplicates: one of the writes lands, as in XLA)."""
    shape = tuple(shape)
    flat, ok, rows = _nd_index(indices, shape)
    m = indices.shape[0]
    base = data.new_zeros((rows,) + shape[m:])
    return _scatter_into(base, flat, ok, rows, data).reshape(shape)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=()):
    """Parity: _scatter_set_nd: ``lhs`` with ``rhs`` written at
    ``indices``."""
    flat, ok, rows = _nd_index(indices, lhs.shape)
    m = indices.shape[0]
    base = lhs.reshape((rows,) + tuple(lhs.shape[m:]))
    return _scatter_into(base, flat, ok, rows, rhs).reshape(lhs.shape)


# ----------------------------------------------------------------------------
# ordering
# ----------------------------------------------------------------------------


@register("sort")
def _sort(data, axis=-1, is_ascend=True):
    """Parity: sort: ascending along ``axis``; descending is the
    ascending result reversed, as the JAX package gives it."""
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort")
def _argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    """Parity: argsort: the stable ascending order along ``axis`` (ties
    by index), reversed when descending; indices in ``dtype``."""
    out = torch.sort(data, dim=axis, stable=True).indices
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(to_torch_dtype(dtype))


@register("topk")
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    """Parity: topk: the ``k`` largest (``is_ascend``: smallest) along
    ``axis``, the lower index first among equal values (``lax.top_k``'s
    order, from a stable sort).  ``ret_typ`` is ``value``, ``both`` or
    ``indices`` (any other value gives the indices, as in the JAX
    package); indices in ``dtype``."""
    x = torch.movedim(data, axis, -1)
    vals, idx = torch.sort(x, dim=-1, descending=not is_ascend, stable=True)
    vals = torch.movedim(vals[..., :k], -1, axis)
    idx = torch.movedim(idx[..., :k], -1, axis).to(to_torch_dtype(dtype))
    if ret_typ == "value":
        return (vals,)
    if ret_typ == "both":
        return (vals, idx)
    return (idx,)


# ----------------------------------------------------------------------------
# creation ops (no tensor input: the dispatcher passes ``device``)
# ----------------------------------------------------------------------------


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


@register("_zeros")
def _zeros(shape=(), dtype="float32", device=None):
    return torch.zeros(_shape(shape), dtype=to_torch_dtype(dtype),
                       device=device)


@register("_ones")
def _ones(shape=(), dtype="float32", device=None):
    return torch.ones(_shape(shape), dtype=to_torch_dtype(dtype),
                      device=device)


@register("_full")
def _full(shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(_shape(shape), value, dtype=to_torch_dtype(dtype),
                      device=device)


@register("_arange")
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None):
    if stop is None:
        start, stop = 0.0, start
    # NumPy's rule: float64 positions, then the requested type
    out = torch.arange(start, stop, step, dtype=torch.float64, device=device)
    out = out.to(to_torch_dtype(dtype))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register("_linspace")
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              device=None):
    num = int(num)
    if endpoint:
        out = torch.linspace(start, stop, num, dtype=torch.float64,
                             device=device)
    else:
        out = torch.linspace(start, stop, num + 1, dtype=torch.float64,
                             device=device)[:num]
    return out.to(to_torch_dtype(dtype))


@register("_eye")
def _eye(N=0, M=0, k=0, dtype="float32", device=None):
    n, m = int(N), int(M) or int(N)
    rows = torch.arange(n, device=device)[:, None]
    cols = torch.arange(m, device=device)[None, :]
    return (cols - rows == int(k)).to(to_torch_dtype(dtype))


@register("zeros_like")
def _zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def _ones_like(data):
    return torch.ones_like(data)


@register("full_like")
def _full_like(data, fill_value=0.0):
    return torch.full_like(data, fill_value)


@register("diag")
def _diag(data, k=0):
    """Parity: diag: a 1-d input's diagonal matrix or a 2-d input's
    diagonal (offset ``k``); for more axes the diagonal of the first two
    moved last, as ``jnp.diagonal`` gives it."""
    if data.dim() <= 2:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=0, dim2=1)


# ----------------------------------------------------------------------------
# dot / batch_dot
# ----------------------------------------------------------------------------


@register("dot")
def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.T if transpose_a and lhs.dim() == 2 else lhs
    b = rhs.T if transpose_b and rhs.dim() == 2 else rhs
    if transpose_a and lhs.dim() > 2:
        a = torch.movedim(lhs, 0, -1)
    if transpose_b and rhs.dim() > 2:
        b = torch.movedim(rhs, -1, 0)
    # MXNet dot: contract the last axis of a with the first axis of b
    if a.dim() == 2 and b.dim() == 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=1)


@register("batch_dot")
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = torch.swapaxes(lhs, -1, -2) if transpose_a else lhs
    b = torch.swapaxes(rhs, -1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("_npi_einsum", aliases=("einsum",))
def _einsum(*operands, subscripts=""):
    """Parity: einsum over ``subscripts``."""
    operands = _amp.transform_inputs("_npi_einsum", operands)
    return torch.einsum(subscripts, *operands)


@register("khatri_rao")
def _khatri_rao(*args, num_args=None):
    """Parity: khatri_rao: the column-wise Kronecker product of the
    (I_n, R) inputs, (prod I_n, R)."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ir,jr->ijr", out, m).reshape(-1, out.shape[-1])
    return out


# ----------------------------------------------------------------------------
# sequence ops (reference: src/operator/sequence_*.cc)
# ----------------------------------------------------------------------------


@register("SequenceMask", aliases=("sequence_mask",),
          inputs=("data", "sequence_length"))
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """Parity: SequenceMask: the steps of each sequence at or past its
    length (``axis`` 0 is time, the other of axes 0 and 1 the batch) set
    to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sequence_length[None, :]            # (T, B)
    if axis == 1:
        mask = mask.T
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    shape[1 - axis] = data.shape[1 - axis]
    return torch.where(mask.reshape(shape), data,
                       torch.full((), value, dtype=data.dtype,
                                  device=data.device))


@register("SequenceLast", aliases=("sequence_last",),
          inputs=("data", "sequence_length"))
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """Parity: SequenceLast: each sequence's last step (at its length)
    along ``axis``."""
    if not use_sequence_length or sequence_length is None:
        return torch.select(data, axis, data.shape[axis] - 1)
    idx = (sequence_length - 1).to(torch.int32).long()
    moved = torch.movedim(data, axis, 0)                        # (T, B, ...)
    idx = idx.reshape((1, -1) + (1,) * (moved.dim() - 2))
    return torch.take_along_dim(moved, idx, 0)[0]


@register("SequenceReverse", aliases=("sequence_reverse",),
          inputs=("data", "sequence_length"))
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """Parity: SequenceReverse: each sequence's first ``length`` steps of
    axis 0 reversed, the rest kept (axis 0 in every case, as in the JAX
    package)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    t = data.shape[0]
    steps = torch.arange(t, device=data.device)[:, None]
    lengths = sequence_length[None, :].to(torch.int32).long()
    rev = torch.where(steps < lengths, lengths - 1 - steps, steps)
    idx = rev.reshape((t, -1) + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.take_along_dim(data, idx, 0)


# ----------------------------------------------------------------------------
# linalg (parity: src/operator/tensor/la_op.cc), over torch.linalg
# ----------------------------------------------------------------------------


def _t(a):
    return a.transpose(-1, -2)


@register("_linalg_gemm2", aliases=("linalg_gemm2",))
def _linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                  axis=-2):
    A, B = _amp.transform_inputs("_linalg_gemm2", (A, B))
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("_linalg_gemm", aliases=("linalg_gemm",))
def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2):
    A, B, C = _amp.transform_inputs("_linalg_gemm", (A, B, C))
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("_linalg_syrk", aliases=("linalg_syrk",))
def _linalg_syrk(A, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(_t(A), A) if transpose
                    else torch.matmul(A, _t(A)))


@register("_linalg_potrf", aliases=("linalg_potrf",))
def _linalg_potrf(A):
    """The lower Cholesky factor."""
    return torch.linalg.cholesky(A)


@register("_linalg_trsm", aliases=("linalg_trsm",))
def _linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """``alpha * op(A)^-1 B`` (or ``B op(A)^-1`` with ``rightside``) for a
    triangular ``A``."""
    a = _t(A) if transpose else A
    low = lower != transpose
    if rightside:
        x = torch.linalg.solve_triangular(_t(a), _t(alpha * B),
                                          upper=low)
        return _t(x)
    return torch.linalg.solve_triangular(a, alpha * B, upper=not low)


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def _linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), -1)


@register("_linalg_extractdiag", aliases=("linalg_extractdiag",))
def _linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("_linalg_makediag", aliases=("linalg_makediag",))
def _linalg_makediag(A, offset=0):
    """The diagonal matrices of the last axis; a non-zero ``offset``
    gives a scalar zero, as the JAX package's op does."""
    if offset != 0:
        return torch.zeros((), dtype=A.dtype, device=A.device)
    return torch.diag_embed(A)


@register("_linalg_svd", aliases=("linalg_svd",))
def _linalg_svd(A):
    """``(U, S, V^T)`` of the reduced SVD."""
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    return u, s, vt


@register("_linalg_inverse", aliases=("linalg_inverse",))
def _linalg_inverse(A):
    return torch.linalg.inv(A)


@register("_linalg_det", aliases=("linalg_det",))
def _linalg_det(A):
    return torch.linalg.det(A)


def _trian_indices(n, offset, lower, device):
    k = -int(offset) if lower else int(offset)
    fn = torch.tril_indices if lower else torch.triu_indices
    return fn(n, n, k, device=device)


@register("_linalg_extracttrian")
def _linalg_extracttrian(A, offset=0, lower=True):
    """The lower (upper) triangle from diagonal ``offset`` in row-major
    order."""
    r, c = _trian_indices(A.shape[-1], offset, lower, A.device)
    return A[..., r, c]


@register("_linalg_maketrian")
def _linalg_maketrian(A, offset=0, lower=True):
    """The (n, n) triangular matrices whose triangle from diagonal
    ``offset`` is the last axis, in row-major order."""
    size = A.shape[-1]
    m = int(round(((8 * size + 1) ** 0.5 - 1) / 2))
    if m * (m + 1) // 2 != size:
        raise ValueError("cannot infer triangular size from %d" % size)
    n = m + abs(int(offset))
    r, c = _trian_indices(n, offset, lower, A.device)
    flat = A.new_zeros(A.shape[:-1] + (n * n,))
    return flat.index_copy(-1, r * n + c, A).reshape(A.shape[:-1] + (n, n))


@register("_linalg_gelqf")
def _linalg_gelqf(A):
    """LQ: ``A = L Q`` with Q's rows orthonormal, from the QR of A^T."""
    q, r = torch.linalg.qr(_t(A), mode="reduced")
    return _t(r), _t(q)


@register("_linalg_potri")
def _linalg_potri(A, lower=True):
    """The inverse of ``L L^T`` (``U^T U``) from its Cholesky factor."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=not lower)
    return _t(linv) @ linv if lower else linv @ _t(linv)


@register("_linalg_slogdet")
def _linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("_linalg_syevd")
def _linalg_syevd(A):
    """``(U, L)`` with ``A = U^T diag(L) U``: the rows of U are the
    eigenvectors."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w


@register("_linalg_trmm")
def _linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = _t(tri)
    return alpha * (B @ tri if rightside else tri @ B)
