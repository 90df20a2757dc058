"""``mx.nd.random`` (parity: ``python/mxnet/ndarray/random.py``; the
port's counterpart of the JAX package's ``ndarray/random.py``, with the
same dispatch: an NDArray first parameter samples per element through
the ``_sample_*`` op, a number draws ``shape`` values through the
``_random_*`` op on ``ctx``, default the current context)."""
from __future__ import annotations

from ..ops import registry as _reg
from .ndarray import NDArray


def _run(name, shape, dtype, ctx, attrs, inputs=()):
    attrs = dict(attrs)
    if shape is not None:
        attrs["shape"] = tuple(shape) if isinstance(shape, (tuple, list)) \
            else (shape,)
    if dtype is not None:
        attrs["dtype"] = dtype
    attrs["ctx"] = ctx
    return _reg.invoke(name, list(inputs), attrs)


def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None,
            out=None, **kwargs):
    if isinstance(low, NDArray):
        return _reg.invoke("_sample_uniform", [low, high], {"shape": ()})
    return _run("_random_uniform", shape, dtype, ctx,
                {"low": low, "high": high})


def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None,
           out=None, **kwargs):
    if isinstance(loc, NDArray):
        return _reg.invoke("_sample_normal", [loc, scale], {"shape": ()})
    return _run("_random_normal", shape, dtype, ctx,
                {"loc": loc, "scale": scale})


def randn(*shape, dtype="float32", ctx=None, **kwargs):
    return normal(0.0, 1.0, shape or (1,), dtype=dtype, ctx=ctx)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None,
          out=None):
    if isinstance(alpha, NDArray):
        return _reg.invoke("_sample_gamma", [alpha, beta], {"shape": ()})
    return _run("_random_gamma", shape, dtype, ctx,
                {"alpha": alpha, "beta": beta})


def exponential(scale=1.0, shape=(1,), dtype="float32", ctx=None,
                out=None):
    return _run("_random_exponential", shape, dtype, ctx,
                {"lam": 1.0 / scale})


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    return _run("_random_poisson", shape, dtype, ctx, {"lam": lam})


def negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32", ctx=None,
                      out=None):
    return _run("_random_negative_binomial", shape, dtype, ctx,
                {"k": k, "p": p})


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None):
    return _run("_random_randint", shape, dtype, ctx,
                {"low": low, "high": high})


def multinomial(data, shape=(), get_prob=False, dtype="int32"):
    return _reg.invoke("_sample_multinomial", [data],
                       {"shape": shape, "get_prob": get_prob,
                        "dtype": dtype})


def shuffle(data):
    return _reg.invoke("_shuffle", [data])


def bernoulli(prob=0.5, shape=(1,), dtype="float32", ctx=None):
    return _run("_random_bernoulli", shape, dtype, ctx, {"prob": prob})
