"""``mx.np.random`` (the port's counterpart of the JAX package's
``numpy/random.py``; reference: ``python/mxnet/numpy/random.py``).

Every draw comes from torch's default generator of the output's device,
as ``mx.nd.random``'s do, so ``mx.random.seed`` (or ``np.random.seed``)
repeats it.  The JAX package draws from threefry keys: the two are
compared by moments, never by value.
"""
from __future__ import annotations

import numpy as _onp
import torch

from . import _as_np, _make, _op, ndarray, array  # noqa: F401
from .. import random as _random
from ..context import as_context
from ..ndarray.ndarray import NDArray  # noqa: F401
from ..ops.random_ops import _standard_gamma


def _size(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)


def _fill(draw, ctx):
    """An ``mx.np.ndarray`` over ``draw(device)``, made on ``ctx``."""
    c = as_context(ctx)
    return ndarray._wrap(draw(c.torch_device), c)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None):
    return _make("_npi_uniform", {"low": low, "high": high,
                                  "size": _size(size),
                                  "dtype": dtype or "float32"}, ctx)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    return _make("_npi_normal", {"loc": loc, "scale": scale,
                                 "size": _size(size),
                                 "dtype": dtype or "float32"}, ctx)


def randn(*size):
    return normal(size=size or None)


def rand(*size):
    return uniform(size=size or None)


def randint(low, high=None, size=None, dtype="int32", ctx=None):
    if high is None:
        low, high = 0, low
    return _make("_random_randint", {"low": low, "high": high,
                                     "shape": _size(size), "dtype": dtype},
                 ctx)


def choice(a, size=None, replace=True, p=None, ctx=None):
    """Values drawn from the pool ``a`` (an array, or ``arange(a)`` for an
    int), with probabilities ``p``."""
    if isinstance(a, int):
        pool = _make("_npi_arange", {"start": 0, "stop": a, "step": 1,
                                     "dtype": "int32"}, ctx)
    else:
        pool = a if isinstance(a, NDArray) else array(a, ctx=ctx)
    ins = [pool] if p is None else [pool, p if isinstance(p, NDArray)
                                    else array(p, ctx=pool.context)]
    idx = _op("_npi_choice", ins, {"size": _size(size),
                                   "replace": replace})
    return _op("take", [pool, idx], {"axis": 0})


def shuffle(x):
    """Permute ``x`` in place along its first axis."""
    perm = torch.randperm(x.shape[0], device=x._data.device)
    x._set_data(x._data[perm])


def permutation(x):
    if isinstance(x, int):
        return _fill(lambda d: torch.randperm(x, device=d).to(torch.int32),
                     None)
    arr = x if isinstance(x, NDArray) else array(x)
    perm = torch.randperm(arr.shape[0], device=arr._data.device)
    return _as_np(arr.__class__._wrap(arr._data[perm], arr.context))


def beta(a, b, size=None, ctx=None):
    """``X / (X + Y)`` of two gamma draws, as ``jax.random.beta``."""
    shape = _size(size)

    def draw(d):
        x = _standard_gamma(a, shape, d)
        return x / (x + _standard_gamma(b, shape, d))
    return _fill(draw, ctx)


def gamma(shape, scale=1.0, size=None, ctx=None):
    return _make("_npi_gamma", {"shape": shape, "scale": scale,
                                "size": _size(size)}, ctx)


def exponential(scale=1.0, size=None, ctx=None):
    return _make("_npi_exponential", {"scale": scale, "size": _size(size)},
                 ctx)


def poisson(lam=1.0, size=None, ctx=None):
    return _fill(lambda d: torch.poisson(torch.full(
        _size(size), float(lam), dtype=torch.float32, device=d)).to(
            torch.int32), ctx)


def multinomial(n, pvals, size=None):
    """int32 counts of ``n`` draws an experiment, shape ``size + (k,)``."""
    p = pvals if isinstance(pvals, NDArray) else array(
        _onp.asarray(pvals, _onp.float32))
    return _op("_npi_multinomial", [p], {"n": n, "size": _size(size)})


def seed(s):
    _random.seed(s)

