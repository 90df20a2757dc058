"""Weight initializers (the counterpart of ``mxnet_tpu/initializer.py``).

An initializer is called with a parameter's name (a string or an
``InitDesc``) and its tensor and fills the tensor in place, drawing from
an explicit ``torch.Generator`` (on the tensor's device) when one is
given.  The registry, construction by name (``create("xavier")``) or by
``dumps()``'s JSON, and the name-suffix defaults of the JAX package are
kept: a name ending in ``bias``, ``beta``, ``running_mean`` or
``moving_mean`` gets zeros, ``gamma``, ``running_var`` or ``moving_var``
ones, anything else the initializer's own rule; an ``InitDesc`` whose
``attrs`` name an ``__init__`` gets that initializer's rule whatever the
name.  Torch's generators give other numbers than ``jax.random`` from
the same seed, so the random initializers agree with the JAX package in
distribution, not in values; ``Bilinear``, ``LSTMBias``, ``Load`` and
``Mixed``'s dispatch give its values exactly.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError

_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer class under its lowercased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """A parameter's name with ``attrs`` (parity: initializer.InitDesc):
    ``attrs["__init__"]``, an initializer's name or ``dumps()``, picks
    the rule whatever the name says."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


_ZERO_SUFFIXES = ("bias", "beta", "running_mean", "moving_mean")
_ONE_SUFFIXES = ("gamma", "running_var", "moving_var")


class Initializer:
    """Base initializer (parity: initializer.Initializer)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON, which ``create`` reads back."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, name, tensor, generator=None):
        """Fill ``tensor`` (the parameter called ``name``) in place."""
        init = getattr(name, "attrs", {}).get("__init__", "")
        name = str(name)
        with torch.no_grad():
            if init:
                create(init)._init_weight(name, tensor, generator)
            elif name.endswith("weight"):
                self._init_weight(name, tensor, generator)
            elif name.endswith(_ZERO_SUFFIXES):
                tensor.zero_()
            elif name.endswith(_ONE_SUFFIXES):
                tensor.fill_(1.0)
            else:
                self._init_weight(name, tensor, generator)
        return tensor

    def _init_weight(self, name, tensor, generator):  # pragma: no cover
        raise NotImplementedError

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._kwargs)


def create(init, **kwargs):
    """Resolve a registered name or an instance into an Initializer;
    ``None`` gives ``Uniform()``."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform()
    if isinstance(init, (list, tuple)) and len(init) == 2:
        name, kw = init                     # dumps(), decoded
        return _INIT_REGISTRY[str(name).lower()](**kw)
    if isinstance(init, str):
        s = init.strip()
        if s.startswith("["):
            return create(json.loads(s))
        if s.lower() not in _INIT_REGISTRY:
            raise MXNetError("unknown initializer %r" % init)
        return _INIT_REGISTRY[s.lower()](**kwargs)
    raise TypeError("cannot create initializer from %r" % (init,))


@register
class Zero(Initializer):
    def _init_weight(self, name, tensor, generator):
        tensor.zero_()


@register
class One(Initializer):
    def _init_weight(self, name, tensor, generator):
        tensor.fill_(1.0)


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    """Every element ``value`` (parity: initializer.Constant)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, tensor, generator):
        tensor.fill_(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, tensor, generator):
        tensor.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, tensor, generator):
        tensor.normal_(0.0, self.sigma, generator=generator)


def _fan_in_out(shape):
    if len(shape) < 2:
        raise MXNetError("Xavier-family initializers need >=2-d shapes, "
                         "got %s" % (tuple(shape),))
    hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
    return shape[1] * hw, shape[0] * hw


@register
class Xavier(Initializer):
    """Parity: initializer.Xavier (``rnd_type``, ``factor_type``,
    ``magnitude``): uniform on ±sqrt(magnitude / factor) or gaussian
    with that standard deviation, factor the mean of fan-in and fan-out
    (``avg``), fan-in (``in``) or fan-out (``out``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, tensor, generator):
        fan_in, fan_out = _fan_in_out(tuple(tensor.shape))
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError("invalid factor_type %r" % self.factor_type)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            tensor.uniform_(-scale, scale, generator=generator)
        elif self.rnd_type == "gaussian":
            tensor.normal_(0.0, scale, generator=generator)
        else:
            raise MXNetError("invalid rnd_type %r" % self.rnd_type)


@register
class Orthogonal(Initializer):
    """An orthonormal matrix times ``scale`` (parity:
    initializer.Orthogonal): the SVD of a ``(shape[0], prod(shape[1:]))``
    draw from U(-1, 1) (``rand_type="uniform"``) or N(0, 1), its left
    factor where that has the draw's shape, else its right one."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, tensor, generator):
        nout = tensor.shape[0]
        nin = math.prod(tensor.shape[1:]) if tensor.dim() > 1 else 1
        tmp = torch.empty((nout, nin), dtype=torch.float32,
                          device=tensor.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        tensor.copy_(self.scale * q.reshape(tensor.shape))


@register
class MSRAPrelu(Xavier):
    """Gaussian Xavier with magnitude ``2 / (1 + slope^2)`` (parity:
    initializer.MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernels over the last two axes (parity:
    initializer.Bilinear)."""

    def _init_weight(self, name, tensor, generator):
        shape = tuple(tensor.shape)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))) \
            .astype(np.float32)
        tensor.copy_(torch.from_numpy(w.reshape(shape)))


@register
class LSTMBias(Initializer):
    """Zeros, and ``forget_bias`` on the forget gate's quarter (gates
    i, f, g, o; parity: initializer.LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, tensor, generator):
        n = tensor.shape[0] // 4
        tensor.zero_()
        tensor[n:2 * n] = self.forget_bias


@register
class FusedRNN(Initializer):
    """A packed RNN parameter filled by ``init`` (default
    ``Uniform(0.1)``; parity: initializer.FusedRNN)."""

    def __init__(self, init=None, state_size=0, num_layers=1, mode="lstm",
                 bidirectional=False, forget_bias=1.0):
        super().__init__()
        self._init = create(init) if init is not None else Uniform(0.1)
        self._forget = forget_bias

    def _init_weight(self, name, tensor, generator):
        self._init._init_weight(name, tensor, generator)


class Load(Initializer):
    """Fill from a dict of arrays by name (``arg:``/``aux:`` prefixes
    dropped), else from ``default_init`` (parity: initializer.Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, tensor, generator=None):
        key = str(name)
        if key in self.param:
            arr = self.param[key]
            arr = torch.as_tensor(arr.asnumpy() if hasattr(arr, "asnumpy")
                                  else arr)
            if tuple(arr.shape) != tuple(tensor.shape):
                raise MXNetError("Load: shape mismatch for %s: %s vs %s"
                                 % (key, tuple(arr.shape),
                                    tuple(tensor.shape)))
            with torch.no_grad():
                tensor.copy_(arr)
            return tensor
        if self.default_init is None:
            raise MXNetError("Load: no init for %s" % key)
        return create(self.default_init)(name, tensor, generator)


class Mixed(Initializer):
    """The first initializer whose pattern (a regular expression)
    matches the name (parity: initializer.Mixed)."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must pair up")
        self.map = [(re.compile(p), create(init))
                    for p, init in zip(patterns, initializers)]

    def __call__(self, name, tensor, generator=None):
        for prog, init in self.map:
            if prog.match(str(name)):
                return init(name, tensor, generator)
        raise MXNetError("no matching pattern for %s" % str(name))
