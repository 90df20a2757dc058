"""The NumPy-internal ops (``_np*``/``_npi_*``/``_npx_*``): the port's
counterpart of the JAX package's ``ops/npi.py`` (reference:
``src/operator/numpy/*.cc``), under its names, aliases, attributes and
defaults, as plain PyTorch.

Types follow jnp with its 64-bit types off, as the JAX package's ops give
them: integer sums stay 32-bit, ``argmax``/``digitize``/``histogram``
counts and the random indices are int32, float results of integer input
are float32.  A 64-bit input stays 64-bit (the port's rule for
``mx.nd``, ROADMAP.md §1).

The ops whose output shape depends on the data (``_npi_bincount``,
``_npi_unique``, ``_npx_nonzero``, ``_npi_delete`` and the four set ops)
read their inputs on the host, as the JAX package's do, through
``register_invoke_override``: they are never deferred into a bulk
segment, and under a CUDA graph capture they raise ``MXNetError`` naming
the op (``graph_cache.refuse_host_read``).  The samplers draw from
torch's default generator of the output's device (``ops/random_ops.py``);
the negative binomials are gamma–Poisson mixtures, as in the JAX
package.
"""
from __future__ import annotations

import inspect
import math

import numpy as _onp
import torch

from .random_ops import _standard_gamma
from .registry import register, register_invoke_override
from .tensor import _div, _int_accum, _rdiv, _true_div_args, to_torch_dtype

_WIDE = (torch.int64, torch.float64)


def _dims(axis, ndim):
    """``axis`` (None, an int, a tuple or list) as a tuple of dims."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) % ndim for a in axis)
    return (int(axis) % max(ndim, 1),)


def _float(x):
    """``x`` in float32 unless it is floating already."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _const(x, value, dtype=None):
    """``value`` as a 0-d tensor of ``dtype`` (``x``'s by default) on
    ``x``'s device: a fill, so that a captured graph may hold it."""
    dtype = dtype or x.dtype
    if not dtype.is_floating_point and dtype != torch.bool:
        value = int(value)
    elif dtype == torch.bool:
        value = bool(value)
    return torch.full((), value, dtype=dtype, device=x.device)


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(int(s) for s in size)


# ---------------------------------------------------------------------------
# reductions and shape manipulation (the _np_* names)
# ---------------------------------------------------------------------------


def _amax(x, dims, keepdims):
    return torch.amax(x, dims, keepdim=keepdims) if dims else x.clone()


def _amin(x, dims, keepdims):
    return torch.amin(x, dims, keepdim=keepdims) if dims else x.clone()


def _sum(x, dims, keepdims):
    out = torch.sum(x, dims, keepdim=keepdims) if dims else x.clone()
    return _int_accum(out.to(torch.int64) if x.dtype == torch.bool
                      and not dims else out, x)


def _prod(x, dims, keepdims):
    out = x
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, d, keepdim=keepdims)
    if not dims:
        out = x.to(torch.int64) if x.dtype == torch.bool else x.clone()
    return _int_accum(out, x)


@register("_np_all")
def _np_all(data, axis=None, keepdims=False):
    dims = _dims(axis, data.dim())
    out = data.bool()
    for d in sorted(dims, reverse=True):
        out = torch.all(out, d, keepdim=bool(keepdims))
    return out


@register("_np_any")
def _np_any(data, axis=None, keepdims=False):
    dims = _dims(axis, data.dim())
    out = data.bool()
    for d in sorted(dims, reverse=True):
        out = torch.any(out, d, keepdim=bool(keepdims))
    return out


@register("_np_sum")
def _np_sum(a, axis=None, dtype=None, keepdims=False):
    return _sum(a, _dims(axis, a.dim()), bool(keepdims))


@register("_np_max")
def _np_max(a, axis=None, keepdims=False):
    return _amax(a, _dims(axis, a.dim()), bool(keepdims))


@register("_np_min")
def _np_min(a, axis=None, keepdims=False):
    return _amin(a, _dims(axis, a.dim()), bool(keepdims))


@register("_np_prod")
def _np_prod(a, axis=None, dtype=None, keepdims=False):
    return _prod(a, _dims(axis, a.dim()), bool(keepdims))


@register("_npi_mean")
def _npi_mean(a, axis=None, dtype=None, keepdims=False):
    dims = _dims(axis, a.dim())
    x = _float(a)
    return torch.mean(x, dims, keepdim=bool(keepdims)) if dims else x.clone()


def _moment(a, axis, ddof, keepdims, std):
    dims = _dims(axis, a.dim())
    x = _float(a)
    out = torch.var(x, dims, correction=ddof, keepdim=bool(keepdims))
    return torch.sqrt(out) if std else out


@register("_npi_std")
def _npi_std(a, axis=None, ddof=0, keepdims=False):
    return _moment(a, axis, ddof, keepdims, True)


@register("_npi_var")
def _npi_var(a, axis=None, ddof=0, keepdims=False):
    return _moment(a, axis, ddof, keepdims, False)


@register("_np_cumsum")
def _np_cumsum(a, axis=None, dtype=None):
    x = a.reshape(-1) if axis is None else a
    out = torch.cumsum(x, int(axis) if axis is not None else 0)
    return _int_accum(out, a, running=True)


register("_np_copy")(lambda a: a.to(torch.int32) if a.dtype == torch.bool
                     else a.clone())


@register("_np_reshape")
def _np_reshape(a, newshape=(), order="C"):
    return a.reshape(_shape(newshape))


@register("_npx_reshape")
def _npx_reshape(a, newshape=(), reverse=False):
    return a.reshape(_shape(newshape))


@register("_np_squeeze")
def _np_squeeze(a, axis=None):
    if axis is None:
        return a.squeeze()
    return a.squeeze(_dims(axis, a.dim()))


@register("_np_transpose")
def _np_transpose(a, axes=None):
    axes = tuple(reversed(range(a.dim()))) if axes is None else \
        tuple(int(x) for x in axes)
    return a.permute(axes)


@register("_np_moveaxis")
def _np_moveaxis(a, source=0, destination=0):
    src = list(source) if isinstance(source, (tuple, list)) else source
    dst = list(destination) if isinstance(destination, (tuple, list)) \
        else destination
    return torch.movedim(a, src, dst)


@register("_np_roll")
def _np_roll(a, shift=0, axis=None):
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    shifts = tuple(shift) if isinstance(shift, (tuple, list)) else shift
    dims = tuple(axis) if isinstance(axis, (tuple, list)) else axis
    if isinstance(dims, tuple) and not isinstance(shifts, tuple):
        shifts = (shifts,) * len(dims)
    return torch.roll(a, shifts, dims)


@register("_npi_rot90")
def _npi_rot90(a, k=1, axes=(0, 1)):
    return torch.rot90(a, int(k), tuple(axes))


@register("_npi_flip")
def _npi_flip(a, axis=None):
    return torch.flip(a, _dims(axis, a.dim()))


@register("_np_diag")
def _np_diag(a, k=0):
    return torch.diag(a, int(k))


@register("_np_diagflat")
def _np_diagflat(a, k=0):
    return torch.diagflat(a.reshape(-1), int(k))


@register("_np_diagonal")
def _np_diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, int(offset), int(axis1), int(axis2))


@register("_np_trace")
def _np_trace(a, offset=0, axis1=0, axis2=1):
    d = torch.diagonal(a, int(offset), int(axis1), int(axis2))
    return _int_accum(d.sum(-1), a)


@register("_npi_tril")
def _npi_tril(a, k=0):
    return torch.tril(a, int(k))


def _dot(a, b):
    """``jnp.dot``: a product with a scalar, the inner product of two
    vectors, else the sum over ``a``'s last axis and ``b``'s second to
    last (its only one for a vector)."""
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, ([-1], [-1 if b.dim() == 1 else -2]))


register("_np_dot")(lambda a, b: _dot(a, b))


@register("_npi_broadcast_to")
def _npi_broadcast_to(a, shape=()):
    return torch.broadcast_to(a, _shape(shape)).clone()


register("_npi_share_memory")(
    lambda a, b: torch.zeros((1,), dtype=torch.bool, device=a.device))


@register("_np_atleast_1d")
def _np_atleast_1d(*arys):
    return tuple(torch.atleast_1d(a) for a in arys)


@register("_np_atleast_2d")
def _np_atleast_2d(*arys):
    return tuple(torch.atleast_2d(a) for a in arys)


@register("_np_atleast_3d")
def _np_atleast_3d(*arys):
    return tuple(torch.atleast_3d(a) for a in arys)


# ---------------------------------------------------------------------------
# elementwise binary (and the scalar and reflected-scalar forms)
# ---------------------------------------------------------------------------


def _binary(name, fn):
    """``name(lhs, rhs)`` and ``name_scalar(data, scalar)``, the scalar
    in the data's type (jnp's ``asarray(scalar, data.dtype)``)."""
    register(name)(lambda lhs, rhs: fn(lhs, rhs))
    register(name + "_scalar")(
        lambda data, scalar=0.0, is_int=False: fn(data, _const(data, scalar)))


def _rbinary(name, fn):
    register(name)(lambda data, scalar=0.0, is_int=False: fn(
        _const(data, scalar), data))


def _i32(x):
    return x.to(torch.int32)


_binary("_npi_add", torch.add)
_binary("_npi_subtract", torch.subtract)
_rbinary("_npi_rsubtract_scalar", torch.subtract)
_binary("_npi_multiply", torch.multiply)
_binary("_npi_mod", torch.remainder)
_rbinary("_npi_rmod_scalar", torch.remainder)
_binary("_npi_power", torch.pow)
_rbinary("_npi_rpower_scalar", torch.pow)
_binary("_npi_copysign", lambda a, b: torch.copysign(_float(a), _float(b)))
_rbinary("_npi_rcopysign_scalar",
         lambda a, b: torch.copysign(_float(a), _float(b)))
_binary("_npi_arctan2", lambda a, b: torch.atan2(_float(a), _float(b)))
_rbinary("_npi_rarctan2_scalar",
         lambda a, b: torch.atan2(_float(a), _float(b)))
_binary("_npi_lcm", lambda a, b: torch.lcm(_i32(a), _i32(b)))
_binary("_npi_ldexp", lambda a, b: _float(a) * torch.pow(
    _const(a, 2.0, _float(a).dtype), _i32(b).to(_float(a).dtype)))
_rbinary("_npi_rldexp_scalar", lambda a, b: _float(a) * torch.pow(
    _const(a, 2.0, _float(a).dtype), _i32(b).to(_float(a).dtype)))
_binary("_npi_bitwise_or", lambda a, b: torch.bitwise_or(_i32(a), _i32(b)))
_binary("_npi_bitwise_xor", lambda a, b: torch.bitwise_xor(_i32(a), _i32(b)))
register("_npi_bitwise_not")(lambda data: torch.bitwise_not(_i32(data)))


@register("_npi_true_divide")
def _npi_true_divide(lhs, rhs):
    dt = torch.result_type(lhs, rhs)
    if not dt.is_floating_point:
        dt = torch.float32
    return torch.true_divide(lhs.to(dt), rhs.to(dt))


register("_npi_true_divide_scalar")(
    lambda data, scalar=1.0, is_int=False: _div(*_true_div_args(data,
                                                                scalar)))
register("_npi_rtrue_divide_scalar")(
    lambda data, scalar=1.0, is_int=False: _rdiv(
        *_true_div_args(data, scalar)[::-1]))
register("_npi_hypot")(lambda x1, x2: torch.hypot(_float(x1), _float(x2)))
register("_npi_log")(lambda data: torch.log(_float(data)))
register("_npi_logical_not")(lambda data: torch.logical_not(data))
register("_npi_deg2rad")(lambda data: torch.deg2rad(_float(data)))
register("_npi_rad2deg")(lambda data: torch.rad2deg(_float(data)))


@register("_npi_around")
def _npi_around(data, decimals=0):
    if not data.is_floating_point():
        return data.clone()
    return torch.round(data, decimals=int(decimals))


@register("_npi_nan_to_num", aliases=("_npi_backward_nan_to_num",))
def _npi_nan_to_num(data, copy=True, nan=0.0, posinf=None, neginf=None):
    if not data.is_floating_point():
        return data.clone()
    return torch.nan_to_num(data, nan=nan, posinf=posinf, neginf=neginf)


register("_npx_relu")(lambda data: torch.clamp_min(data, 0))
register("_npx_sigmoid")(lambda data: torch.sigmoid(_float(data)))


@register("_npx_constraint_check")
def _npx_constraint_check(data, msg="constraint violated"):
    """Whether every element holds (the reference raises at wait time on
    a violation; the JAX package gives the value)."""
    return torch.all(data.bool())


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1), 0)
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = fn(data, int(axis), keepdim=bool(keepdims))
    return out.to(torch.int32)


@register("_npi_argmax")
def _npi_argmax(data, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("_npi_argmin")
def _npi_argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("_npi_average", inputs=("a", "weights"))
def _npi_average(a, weights=None, axis=None, returned=False):
    """``(average, sum of weights)``; without weights the count of the
    averaged elements broadcast to the average's shape."""
    dims = _dims(axis, a.dim())
    if weights is None:
        avg = torch.mean(_float(a), dims)
        cnt = a.numel() / max(avg.numel(), 1)
        return avg, torch.full(avg.shape, cnt, dtype=avg.dtype,
                               device=a.device)
    num = torch.sum(a * weights, dims)
    den = torch.sum(torch.broadcast_to(weights, a.shape), dims)
    return num / den, den


@register("_npi_diff")
def _npi_diff(a, n=1, axis=-1):
    return torch.diff(a, int(n), int(axis))


# ---------------------------------------------------------------------------
# windows (numpy's formulas, in f64 and then in the asked type)
# ---------------------------------------------------------------------------


def _window(kind, M, dtype, device):
    M = int(M)
    dt = to_torch_dtype(dtype)
    if M < 1:
        return torch.zeros((0,), dtype=dt, device=device)
    if M == 1:
        return torch.ones((1,), dtype=dt, device=device)
    n = torch.arange(M, dtype=torch.float64, device=device)
    x = 2 * math.pi * n / (M - 1)
    if kind == "hanning":
        w = 0.5 - 0.5 * torch.cos(x)
    elif kind == "hamming":
        w = 0.54 - 0.46 * torch.cos(x)
    elif kind == "blackman":
        w = 0.42 - 0.5 * torch.cos(x) + 0.08 * torch.cos(2 * x)
    else:
        r = 2 * n / (M - 1)
        w = torch.where(n <= (M - 1) / 2, r, 2 - r)
    return w.to(dt)


@register("_npi_blackman")
def _npi_blackman(M=1, dtype="float32", ctx=None, device=None):
    return _window("blackman", M, dtype, device)


@register("_npi_hamming")
def _npi_hamming(M=1, dtype="float32", ctx=None, device=None):
    return _window("hamming", M, dtype, device)


@register("_npi_hanning")
def _npi_hanning(M=1, dtype="float32", ctx=None, device=None):
    return _window("hanning", M, dtype, device)


@register("_npi_bartlett")
def _npi_bartlett(M=10, ctx=None, dtype="float32", device=None):
    return _window("bartlett", M, dtype, device)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


@register("_npi_zeros")
def _npi_zeros(shape=(), dtype="float32", ctx=None, device=None):
    return torch.zeros(_shape(shape), dtype=to_torch_dtype(dtype),
                       device=device)


@register("_npi_ones")
def _npi_ones(shape=(), dtype="float32", ctx=None, device=None):
    return torch.ones(_shape(shape), dtype=to_torch_dtype(dtype),
                      device=device)


@register("_npi_identity")
def _npi_identity(shape=(), dtype="float32", ctx=None, device=None):
    n = int(shape[0]) if isinstance(shape, (tuple, list)) else int(shape)
    return torch.eye(n, dtype=to_torch_dtype(dtype), device=device)


@register("_npi_eye")
def _npi_eye(N=1, M=None, k=0, dtype="float32", ctx=None, device=None):
    n, m = int(N), int(M) if M else int(N)
    out = torch.zeros((n, m), dtype=to_torch_dtype(dtype), device=device)
    out.diagonal(int(k)).fill_(1)
    return out


@register("_npi_arange")
def _npi_arange(start=0.0, stop=None, step=1.0, dtype="float32", ctx=None,
                device=None):
    if stop is None:
        start, stop = 0.0, start
    return torch.arange(start, stop, step, dtype=to_torch_dtype(dtype),
                        device=device)


@register("_npi_logspace")
def _npi_logspace(start=0.0, stop=1.0, num=50, endpoint=True, base=10.0,
                  dtype="float32", ctx=None, device=None):
    num = int(num)
    if endpoint:
        lin = torch.linspace(start, stop, num, dtype=torch.float32,
                             device=device)
    else:
        lin = torch.linspace(start, stop, num + 1, dtype=torch.float32,
                             device=device)[:num]
    base_t = torch.full((), float(base), dtype=torch.float32, device=device)
    return torch.pow(base_t, lin).to(to_torch_dtype(dtype))


@register("_npi_indices")
def _npi_indices(dimensions=(), dtype="int32", ctx=None, device=None):
    grids = torch.meshgrid(*[torch.arange(int(d), device=device)
                             for d in dimensions], indexing="ij")
    return torch.stack(grids).to(to_torch_dtype(dtype))


@register("_npi_full_like")
def _npi_full_like(a, fill_value=0.0, dtype=None, ctx=None):
    dt = to_torch_dtype(dtype) or a.dtype
    return torch.full(a.shape, fill_value, dtype=dt, device=a.device)


# ---------------------------------------------------------------------------
# stacking and splitting
# ---------------------------------------------------------------------------


@register("_npi_concatenate")
def _npi_concatenate(*data, axis=0, dim=None, num_args=1):
    return torch.cat(data, int(dim if dim is not None else axis))


@register("_npi_stack")
def _npi_stack(*data, axis=0, num_args=1):
    return torch.stack(data, int(axis))


register("_npi_vstack")(lambda *data, num_args=1: torch.vstack(data))
register("_npi_hstack")(lambda *data, num_args=1: torch.hstack(data))
register("_npi_dstack")(lambda *data, num_args=1: torch.dstack(data))
register("_npi_column_stack")(
    lambda *data, num_args=1: torch.column_stack(data))


@register("_npi_hsplit", aliases=("_npi_hsplit_backward",))
def _npi_hsplit(data, indices=None, axis=1, squeeze_axis=False, sections=0):
    """``jnp.split`` along axis 1 (axis 0 of a vector): ``sections``
    equal parts, or at ``indices``."""
    dim = 1 if data.dim() > 1 else 0
    if sections:
        if data.shape[dim] % int(sections):
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(data, int(sections), dim))
    return tuple(torch.tensor_split(data, [int(i) for i in indices], dim))


@register("_npi_where")
def _npi_where(condition, x, y):
    return torch.where(condition.bool(), x, y)


@register("_npi_boolean_mask_assign_scalar")
def _npi_boolean_mask_assign_scalar(data, mask, value=0.0):
    return torch.where(mask.bool(), _const(data, value), data)


@register("_npi_boolean_mask_assign_tensor")
def _npi_boolean_mask_assign_tensor(data, mask, value):
    return torch.where(mask.bool(), value, data)


# ---------------------------------------------------------------------------
# linear algebra (the _npi names; the _linalg_* family is in tensor.py)
# ---------------------------------------------------------------------------


def _pinv(a, rcond):
    if rcond is None:
        rcond = 10 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=float(rcond))


register("_npi_cholesky")(lambda a: torch.linalg.cholesky(a))
register("_npi_solve")(lambda a, b: torch.linalg.solve(a, b))
register("_npi_pinv")(lambda a, rcond=None: _pinv(a, rcond))
register("_npi_pinv_scalar_rcond")(lambda a, rcond=1e-15: _pinv(a, rcond))


@register("_npi_svd")
def _npi_svd(a):
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return u, s, vt


@register("_npi_tensorinv")
def _npi_tensorinv(a, ind=2):
    ind = int(ind)
    head, tail = a.shape[:ind], a.shape[ind:]
    inv = torch.linalg.inv(a.reshape(math.prod(head), math.prod(tail)))
    return inv.reshape(tail + head)


register("_npi_tensorsolve")(
    lambda a, b, a_axes=None: torch.linalg.tensorsolve(a, b))


@register("_npi_tensordot")
def _npi_tensordot(a, b, a_axes_summed=(), b_axes_summed=()):
    return torch.tensordot(a, b, (list(a_axes_summed), list(b_axes_summed)))


register("_npi_tensordot_int_axes")(
    lambda a, b, axes=2: torch.tensordot(a, b, int(axes)))


# ---------------------------------------------------------------------------
# random (torch's default generator of the output's device)
# ---------------------------------------------------------------------------


@register("_npi_uniform", aliases=("_npi_uniform_n",), needs_rng=True)
def _npi_uniform(low=0.0, high=1.0, size=(), ctx=None, dtype="float32",
                 device=None):
    return torch.empty(_shape(size), dtype=to_torch_dtype(dtype),
                       device=device).uniform_(low, high)


@register("_npi_normal", aliases=("_npi_normal_n",), needs_rng=True)
def _npi_normal(loc=0.0, scale=1.0, size=(), ctx=None, dtype="float32",
                device=None):
    z = torch.empty(_shape(size), dtype=to_torch_dtype(dtype),
                    device=device).normal_()
    return loc + scale * z


@register("_npi_bernoulli", needs_rng=True)
def _npi_bernoulli(prob=0.5, logit=None, size=(), ctx=None, dtype="float32",
                   is_logit=False, device=None):
    u = torch.empty(_shape(size), dtype=torch.float32, device=device)
    u.uniform_()
    p = 1.0 / (1.0 + math.exp(-float(logit))) if is_logit else float(prob)
    return (u < p).to(to_torch_dtype(dtype))


@register("_npi_exponential", needs_rng=True)
def _npi_exponential(scale=1.0, size=(), ctx=None, device=None):
    return scale * torch.empty(_shape(size), dtype=torch.float32,
                               device=device).exponential_()


@register("_npi_gamma", needs_rng=True)
def _npi_gamma(shape=1.0, scale=1.0, size=(), ctx=None, dtype="float32",
               device=None):
    g = _standard_gamma(shape, _shape(size), device)
    return (scale * g).to(to_torch_dtype(dtype))


@register("_npi_choice", inputs=("input1", "input2"), needs_rng=True)
def _npi_choice(input1=None, input2=None, a=None, size=(), replace=True,
                ctx=None, device=None):
    """``np.random.choice``'s backend op: int32 indices into a pool of
    ``a`` (the attr) or of the 1-d ``input1``'s length, drawn with the
    probabilities in the next input, if any (as the JAX package's op,
    which returns indices, never values)."""
    if a is not None:
        n_pool, p = int(a), input1
    else:
        n_pool, p = int(input1.shape[0]), input2
    dev = p.device if p is not None else \
        input1.device if input1 is not None else device
    shape = _shape(size)
    k = math.prod(shape)
    if p is not None:
        idx = torch.multinomial(_float(p) / p.sum(), k, replacement=bool(
            replace)) if k else torch.zeros((0,), dtype=torch.int64,
                                            device=dev)
    elif replace:
        idx = torch.randint(0, n_pool, (k,), device=dev)
    else:
        idx = torch.randperm(n_pool, device=dev)[:k]
    return idx.reshape(shape).to(torch.int32)


@register("_npi_multinomial", inputs=("data",), needs_rng=True)
def _npi_multinomial(data, n=1, pvals=None, size=(), ctx=None):
    """``n`` draws an experiment over the last axis of ``data``'s
    probabilities: int32 counts of shape ``size + (k,)`` (the batch
    shape of ``data`` without ``size``)."""
    k = data.shape[-1]
    target = _shape(size) or tuple(data.shape[:-1])
    p = torch.clamp_min(_float(data), 1e-30)
    rows = torch.broadcast_to(p, target + (k,)).reshape(-1, k)
    counts = torch.zeros((rows.shape[0], k), dtype=torch.int32,
                         device=data.device)
    if rows.shape[0] and int(n):
        draws = torch.multinomial(rows, int(n), replacement=True)
        counts.scatter_add_(1, draws, torch.ones_like(draws,
                                                      dtype=torch.int32))
    return counts.reshape(target + (k,))


def _out_shape(shape, param):
    return (_shape(shape) + tuple(param.shape)) if shape else \
        tuple(param.shape)


@register("_sample_poisson", needs_rng=True)
def _sample_poisson(lam, shape=()):
    rate = torch.broadcast_to(_float(lam), _out_shape(shape, lam))
    return torch.poisson(rate.contiguous()).to(torch.float32)


@register("_sample_exponential", needs_rng=True)
def _sample_exponential(lam, shape=()):
    e = torch.empty(_out_shape(shape, lam), dtype=torch.float32,
                    device=lam.device).exponential_()
    return (1.0 / _float(lam)) * e


@register("_sample_negative_binomial", needs_rng=True)
def _sample_negative_binomial(k, p, shape=()):
    """Failures before the ``k``-th success: a Poisson draw at a
    Gamma(k) * (1 - p) / p rate."""
    out = _out_shape(shape, k)
    g = _standard_gamma(torch.broadcast_to(k, out), out, k.device)
    lam = g * (1 - p) / torch.clamp_min(p, 1e-12)
    return torch.poisson(lam.contiguous()).to(torch.float32)


@register("_sample_generalized_negative_binomial", needs_rng=True)
def _sample_generalized_negative_binomial(mu, alpha, shape=()):
    """A Poisson draw at a Gamma(1/alpha) * mu * alpha rate: mean ``mu``,
    variance ``mu + alpha mu^2``."""
    out = _out_shape(shape, mu)
    a = 1.0 / torch.clamp_min(_float(alpha), 1e-12)
    g = _standard_gamma(torch.broadcast_to(a, out), out, mu.device)
    lam = g * torch.broadcast_to(mu, out) / a
    return torch.poisson(lam.contiguous()).to(torch.float32)


# ---------------------------------------------------------------------------
# statistics (reference: numpy/multiarray.py, np_percentile_op.cc)
# ---------------------------------------------------------------------------


def _quantile(a, q, axis, method, keepdims):
    """``jnp.quantile`` in f32 over ``axis`` (None: all), ``q`` a number
    or a sequence (its axis first in the result)."""
    x = _float(a).to(torch.float32)
    nd = x.dim()
    dims = _dims(axis, nd)
    rest = [d for d in range(nd) if d not in dims]
    x = x.permute(rest + list(dims)).reshape(
        [x.shape[d] for d in rest] + [-1])
    qt = q if isinstance(q, torch.Tensor) else torch.tensor(
        _onp.asarray(q, _onp.float32), device=x.device) \
        if _onp.ndim(q) else torch.full((), float(q), dtype=torch.float32,
                                        device=x.device)
    out = torch.quantile(x, qt.to(torch.float32), dim=-1,
                         interpolation=str(method))
    if keepdims:
        lead = out.shape[:qt.dim()]
        kept = [1 if d in dims else a.shape[d] for d in range(nd)]
        out = out.reshape(tuple(lead) + tuple(kept))
    return out


@register("_npi_percentile")
def _npi_percentile(a, q=50.0, axis=None, interpolation="linear",
                    keepdims=False):
    qv = torch.full((), float(q), dtype=torch.float32, device=a.device) \
        if not _onp.ndim(q) else torch.tensor(
            _onp.asarray(q, _onp.float32), device=a.device)
    return _quantile(a, qv / 100, axis, interpolation, keepdims)


@register("_npi_quantile")
def _npi_quantile(a, q=0.5, axis=None, interpolation="linear",
                  keepdims=False):
    return _quantile(a, q, axis, interpolation, keepdims)


@register("_npi_median")
def _npi_median(a, axis=None, keepdims=False):
    return _quantile(a, 0.5, axis, "midpoint", keepdims)


def _edges(lo, hi, num):
    """``jnp.linspace(lo, hi, num)`` in f32 (``lo*(1 - s) + hi*s``, the
    last point ``hi``), with ``s = i / (num - 1)`` divided by a device
    scalar: a true division on every device, so the card's edges are the
    host's (the card divides by a host scalar through its reciprocal)."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=lo.device) \
        / torch.full((), div, dtype=torch.float32, device=lo.device)
    out = lo * (1 - step) + hi * step
    return torch.cat([out, hi.reshape(1)])


@register("_npi_histogram")
def _npi_histogram(data, bin_cnt=10, range=None):
    """``(counts, edges)`` as ``jnp.histogram`` gives them: int32 counts,
    f32 edges over ``range`` or the data's own min and max."""
    x = _float(data).reshape(-1).to(torch.float32)
    if range is not None:
        lo = torch.full((), float(range[0]), dtype=torch.float32,
                        device=x.device)
        hi = torch.full((), float(range[1]), dtype=torch.float32,
                        device=x.device)
    else:
        lo, hi = x.min(), x.max()
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    edges = _edges(lo, hi, int(bin_cnt) + 1)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], edges.shape[0] - 1, idx)
    counts = torch.zeros(edges.shape[0] + 1, dtype=torch.int32,
                         device=x.device)
    counts = counts.index_add(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[1:edges.shape[0]], edges


@register("_npi_cov")
def _npi_cov(m, rowvar=True, bias=False, ddof=None):
    x = m.to(torch.float32)
    if x.dim() == 2 and not rowvar:
        x = x.t()
    corr = int(ddof) if ddof is not None else (0 if bias else 1)
    return torch.cov(x, correction=corr)


@register("_npi_corrcoef")
def _npi_corrcoef(x, rowvar=True):
    x = x.to(torch.float32)
    if x.dim() == 2 and not rowvar:
        x = x.t()
    return torch.corrcoef(x)


@register("_npi_ptp")
def _npi_ptp(a, axis=None, keepdims=False):
    dims = _dims(axis, a.dim())
    return _amax(a, dims, bool(keepdims)) - _amin(a, dims, bool(keepdims))


def _nan_count(x, dims, keepdims):
    return torch.sum(~torch.isnan(x), dims, keepdim=keepdims).to(x.dtype)


def _nanmean(x, dims, keepdims):
    return torch.nansum(x, dims, keepdim=keepdims) / _nan_count(
        x, dims, keepdims)


def _nanvar(x, dims, ddof, keepdims):
    mean = _nanmean(x, dims, True)
    dev = torch.where(torch.isnan(x), torch.zeros_like(x), x - mean)
    n = _nan_count(x, dims, keepdims) - int(ddof)
    out = torch.sum(dev * dev, dims, keepdim=keepdims) / n
    return torch.where(n > 0, out, torch.full_like(out, float("nan")))


@register("_npi_nanmean")
def _npi_nanmean(a, axis=None, ddof=0, keepdims=False):
    return _nanmean(a.to(torch.float32), _dims(axis, a.dim()),
                    bool(keepdims))


@register("_npi_nanvar")
def _npi_nanvar(a, axis=None, ddof=0, keepdims=False):
    return _nanvar(a.to(torch.float32), _dims(axis, a.dim()), ddof,
                   bool(keepdims))


@register("_npi_nanstd")
def _npi_nanstd(a, axis=None, ddof=0, keepdims=False):
    return torch.sqrt(_nanvar(a.to(torch.float32), _dims(axis, a.dim()),
                              ddof, bool(keepdims)))


def _nan_extreme(a, axis, keepdims, fn, fill):
    dims = _dims(axis, a.dim())
    if not a.is_floating_point():
        return fn(a, dims, keepdims)
    nan = torch.isnan(a)
    out = fn(torch.where(nan, torch.full_like(a, fill), a), dims, keepdims)
    every = nan
    for d in sorted(dims, reverse=True):
        every = torch.all(every, d, keepdim=keepdims)
    return torch.where(every, torch.full_like(out, float("nan")), out)


@register("_npi_nanmax")
def _npi_nanmax(a, axis=None, keepdims=False):
    return _nan_extreme(a, axis, bool(keepdims), _amax, float("-inf"))


@register("_npi_nanmin")
def _npi_nanmin(a, axis=None, keepdims=False):
    return _nan_extreme(a, axis, bool(keepdims), _amin, float("inf"))


@register("_npi_nansum")
def _npi_nansum(a, axis=None, keepdims=False):
    x = torch.nan_to_num(a, nan=0.0) if a.is_floating_point() else a
    return _int_accum(_sum(x, _dims(axis, a.dim()), bool(keepdims)), a)


@register("_npi_nanprod")
def _npi_nanprod(a, axis=None, keepdims=False):
    x = torch.where(torch.isnan(a), torch.ones_like(a), a) \
        if a.is_floating_point() else a
    return _prod(x, _dims(axis, a.dim()), bool(keepdims))


def _nanarg(a, axis, fn, fill):
    nan = torch.isnan(a) if a.is_floating_point() else \
        torch.zeros_like(a, dtype=torch.bool)
    x = torch.where(nan, torch.full_like(a, fill), a) \
        if a.is_floating_point() else a
    if axis is None:
        res = fn(x.reshape(-1), 0)
        every = torch.all(nan)
    else:
        res = fn(x, int(axis))
        every = torch.all(nan, int(axis))
    return torch.where(every, torch.full_like(res, -1), res).to(torch.int32)


@register("_npi_nanargmax")
def _npi_nanargmax(a, axis=None):
    return _nanarg(a, axis, torch.argmax, float("-inf"))


@register("_npi_nanargmin")
def _npi_nanargmin(a, axis=None):
    return _nanarg(a, axis, torch.argmin, float("inf"))


# ---------------------------------------------------------------------------
# the misc wave
# ---------------------------------------------------------------------------


@register("_npi_polyval", inputs=("p", "x"))
def _npi_polyval(p, x):
    """Horner's rule in f32, as ``jnp.polyval``."""
    p, x = p.to(torch.float32), x.to(torch.float32)
    y = torch.zeros_like(x)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


@register("_npi_ediff1d", inputs=("data", "to_end", "to_begin"))
def _npi_ediff1d(data, to_end=None, to_begin=None):
    flat = data.reshape(-1)
    parts = [flat[1:] - flat[:-1]]
    if to_begin is not None:
        parts.insert(0, to_begin.reshape(-1).to(flat.dtype))
    if to_end is not None:
        parts.append(to_end.reshape(-1).to(flat.dtype))
    return torch.cat(parts)


@register("_npi_digitize", inputs=("x", "bins"))
def _npi_digitize(x, bins, right=False):
    """``jnp.digitize``: the bin of each value, for increasing or
    decreasing ``bins``; int32."""
    if bins.shape[0] == 0:
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    r = not bool(right)
    inc = torch.searchsorted(bins, x, right=r)
    dec = bins.shape[0] - torch.searchsorted(bins.flip(0), x, right=r)
    return torch.where(bins[-1] >= bins[0], inc, dec).to(torch.int32)


@register("_npi_trapz", inputs=("y", "x"))
def _npi_trapz(y, x=None, dx=1.0, axis=-1):
    if x is None:
        return torch.trapezoid(y.to(torch.float32), dx=float(dx),
                               dim=int(axis))
    return torch.trapezoid(y.to(torch.float32), x.to(torch.float32),
                           dim=int(axis))


def _cross3(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


@register("_npi_cross", inputs=("a", "b"))
def _npi_cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    """``jnp.cross`` of vectors of 2 or 3 components (a 2-component
    vector's third is 0; two 2-component vectors give the z component)."""
    if axis is not None:
        axisa = axisb = axisc = int(axis)
    a = torch.movedim(a, int(axisa), -1)
    b = torch.movedim(b, int(axisb), -1)
    if a.shape[-1] == 2 and b.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    if a.shape[-1] == 2:
        a = torch.cat([a, torch.zeros_like(a[..., :1])], -1)
    if b.shape[-1] == 2:
        b = torch.cat([b, torch.zeros_like(b[..., :1])], -1)
    a, b = torch.broadcast_tensors(a, b)
    return torch.movedim(_cross3(a, b), -1, int(axisc))


def _same_type(fn):
    def f(a, b):
        dt = torch.result_type(a, b)
        if not dt.is_floating_point:
            dt = torch.float32
        return fn(a.to(dt), b.to(dt))
    return f


register("_npi_fmod", inputs=("a", "b"))(
    lambda a, b: torch.fmod(*torch.broadcast_tensors(a, b)))
register("_npi_heaviside", inputs=("a", "b"))(_same_type(torch.heaviside))
register("_npi_logaddexp", inputs=("a", "b"))(_same_type(torch.logaddexp))
register("_npi_nextafter", inputs=("a", "b"))(_same_type(torch.nextafter))
register("_npi_gcd", inputs=("a", "b"))(
    lambda a, b: torch.gcd(_i32(a), _i32(b)))


def _spacing(a):
    """``jnp.spacing``: the distance to the next number away from 0 (the
    smallest subnormal, signed, where that distance is 0)."""
    x = _float(a)
    inf = torch.copysign(torch.full_like(x, float("inf")), x)
    res = torch.nextafter(x, inf) - x
    tiny = torch.copysign(torch.full_like(
        x, torch.finfo(x.dtype).smallest_normal
        * torch.finfo(x.dtype).eps), x)
    return torch.where(res == 0, tiny, res)


register("_npi_signbit")(lambda a: torch.signbit(a))
register("_npi_spacing")(lambda a: _spacing(a))
register("_npi_cbrt")(lambda a: torch.sign(_float(a)) * torch.pow(
    torch.abs(_float(a)), 1.0 / 3.0))
register("_npi_positive")(lambda a: a.clone())
register("_npi_fabs")(lambda a: torch.abs(_float(a)))


@register("_npi_isin", inputs=("element", "test_elements"))
def _npi_isin(element, test_elements, assume_unique=False, invert=False):
    return torch.isin(element, test_elements, invert=bool(invert))


# ---------------------------------------------------------------------------
# data-dependent output shapes: read on the host (the reference's
# np_unique_op.cc syncs too), never deferred, refused under a capture
# ---------------------------------------------------------------------------


def _host(x):
    t = x.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _back(arr, like, wide):
    """A numpy result on ``like``'s device, its 64-bit types narrowed to
    32 bits unless an input was 64-bit (jnp's ``asarray`` with its 64-bit
    types off)."""
    arr = _onp.asarray(arr)
    if not wide and arr.dtype == _onp.int64:
        arr = arr.astype(_onp.int32)
    elif not wide and arr.dtype == _onp.float64:
        arr = arr.astype(_onp.float32)
    if arr.dtype == _onp.bool_:
        return torch.from_numpy(arr.astype(_onp.uint8)).bool().to(
            like.device)
    return torch.from_numpy(_onp.ascontiguousarray(arr)).to(like.device)


def _host_read(name, compute, signature):
    """A forward under ``signature`` (the JAX op's: its inputs and its
    attributes with their defaults) that reads its tensor arguments on
    the host, runs ``compute(arrays, **attrs)`` in numpy and gives the
    results back on the first input's device."""
    sig = inspect.signature(signature)

    def forward(*args, **kwargs):
        from ..graph_cache import refuse_host_read

        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        tensors = [v for v in bound.arguments.values()
                   if isinstance(v, torch.Tensor)]
        attrs = {k: v for k, v in bound.arguments.items()
                 if not isinstance(v, torch.Tensor)}
        refuse_host_read(name, tensors[0])
        wide = any(t.dtype in _WIDE for t in tensors)
        res = compute([_host(t) for t in tensors], **attrs)
        if isinstance(res, tuple):
            return tuple(_back(r, tensors[0], wide) for r in res)
        return _back(res, tensors[0], wide)

    forward.__signature__ = sig
    forward.__doc__ = "Read on the host: numpy's %s." % name.split("_")[-1]
    return forward


def _override(name, forward):
    """Run ``forward`` on the inputs' tensors eagerly (the open bulk
    segment flushed first) and wrap its results in the first input's
    class."""
    def handler(inputs, attrs, out):
        from ..engine import Engine

        Engine.get().flush_bulk("host_read:%s" % name)
        attrs = {k: v for k, v in attrs.items() if v is not None}
        x = inputs[0]
        res = forward(*[i._data.detach() for i in inputs], **attrs)
        cls = x._op_result_cls
        outs = [cls._wrap(r, x._ctx) for r in (
            res if isinstance(res, tuple) else (res,))]
        if out is not None:
            for dst, src in zip(out if isinstance(out, (list, tuple))
                                else [out], outs):
                dst._adopt(src)
            return out
        return outs[0] if len(outs) == 1 else outs
    register_invoke_override(name, handler)


def _bincount(arrays, weights=None, minlength=0):
    """``weights``, when given, is the second array."""
    data = arrays[0].astype(_onp.int64).reshape(-1)
    w = arrays[1].reshape(-1) if len(arrays) > 1 else None
    return _onp.bincount(data, weights=w, minlength=int(minlength or 0))


def _unique(arrays, return_index=False, return_inverse=False,
            return_counts=False, axis=None):
    return _onp.unique(arrays[0], return_index=bool(return_index),
                       return_inverse=bool(return_inverse),
                       return_counts=bool(return_counts), axis=axis)


def _nonzero(arrays):
    return _onp.stack(_onp.nonzero(arrays[0]), axis=-1).astype(_onp.int64)


def _delete(arrays, start=None, stop=None, step=None, int_ind=None,
            axis=None, obj=None):
    if len(arrays) > 1:
        obj = arrays[1].astype(_onp.int64)
    elif start is not None:
        obj = slice(int(start), int(stop or 0), int(step or 1))
    else:
        obj = int(int_ind or 0)
    return _onp.delete(arrays[0], obj, axis=axis)


def _set_op(fn, takes_assume_unique):
    def compute(arrays, assume_unique=False):
        kwargs = {"assume_unique": True} if takes_assume_unique \
            and assume_unique else {}
        return fn(*arrays[:2], **kwargs)
    return compute


_HOST_OPS = {
    "_npi_bincount": (_bincount, lambda data, weights=None, minlength=0:
                      None),
    "_npi_unique": (_unique, lambda data, return_index=False,
                    return_inverse=False, return_counts=False, axis=None:
                    None),
    "_npx_nonzero": (_nonzero, lambda data: None),
    "_npi_delete": (_delete, lambda data, obj=None, start=None, stop=None,
                    step=None, int_ind=None, axis=None: None),
}
for _name, _fn, _au in [("intersect1d", _onp.intersect1d, True),
                        ("union1d", _onp.union1d, False),
                        ("setdiff1d", _onp.setdiff1d, True),
                        ("setxor1d", _onp.setxor1d, True)]:
    _HOST_OPS["_npi_" + _name] = (_set_op(_fn, _au),
                                  lambda a, b, assume_unique=False: None)


for _name, (_compute, _sig) in _HOST_OPS.items():
    _fwd = _host_read(_name, _compute, _sig)
    register(_name, inputs=("a", "b") if _name.endswith("1d") else None)(
        _fwd)
    _override(_name, _fwd)
