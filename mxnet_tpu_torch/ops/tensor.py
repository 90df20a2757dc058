"""Tensor operators: elementwise, broadcast, scalar, unary, reductions,
shape manipulation, creation, ``dot`` and ``batch_dot``.

The port's counterpart of the JAX package's ``ops/tensor.py``, op for op
in PyTorch, with the same names, attrs and MXNet semantics where they
differ from NumPy's: ``sum``/``mean``/... take ``axis=()`` for all axes
and ``exclude`` to invert the axis set; ``elemwise_*`` want equal shapes
and ``broadcast_*`` broadcast; ``reshape`` takes the codes 0/-1/-2/-3/-4;
comparisons return the input's dtype; ``argmax``/``argmin`` return
float32.  Not ported yet (``ROADMAP.md`` S7): ``_linalg_*``,
``khatri_rao``, the ``Sequence*`` ops, ``_npi_einsum``, ``sort``,
``argsort``, ``topk``, and the gather/scatter family (``gather_nd``,
``scatter_nd``, ``_scatter_set_nd``, ``one_hot``, ``where``,
``boolean_mask_fill``), ``amp_cast``/``amp_multicast``, ``shape_array``,
``size_array``, ``make_loss`` and ``diag``.
"""
from __future__ import annotations

import numpy as np
import torch

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


def _reduce(fn_name):
    red = _REDUCERS[fn_name]

    def op(x, axis=None, keepdims=False, exclude=False):
        axes = _norm_axis(axis, x.dim(), exclude)
        if not axes:
            return x.clone()
        return red(x, axes, bool(keepdims))

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


_SCALAR_BINARY = {
    "_plus_scalar": lambda x, scalar: x + scalar,
    "_minus_scalar": lambda x, scalar: x - scalar,
    "_rminus_scalar": lambda x, scalar: scalar - x,
    "_mul_scalar": lambda x, scalar: x * scalar,
    "_div_scalar": lambda x, scalar: x / scalar,
    "_rdiv_scalar": lambda x, scalar: scalar / x,
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

# ----------------------------------------------------------------------------
# casts
# ----------------------------------------------------------------------------


@register("cast", aliases=("Cast",))
def _cast(data, dtype="float32"):
    return data.to(to_torch_dtype(dtype))


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
    return torch.cumsum(a, int(axis), dtype=to_torch_dtype(dtype))


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
    """Source index of each padded position along one axis."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return pos.clamp(0, n - 1)
    period = 2 * (n - 1)                       # reflect, edge not repeated
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
    """Parity: where: ``x`` where ``condition`` is non-zero, else ``y``."""
    return torch.where(condition.bool(), x, y)


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
