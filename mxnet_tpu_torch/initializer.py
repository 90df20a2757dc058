"""Weight initializers (the counterpart of ``mxnet_tpu/initializer.py``).

An initializer is called with a parameter's name and its tensor and
fills the tensor in place, drawing from an explicit ``torch.Generator``
(on the tensor's device) when one is given.  The registry, construction
by name (``create("xavier")``) and the name-suffix defaults of the JAX
package are kept: a name ending in ``bias`` or ``beta`` gets zeros,
``gamma`` ones, anything else the initializer's own rule.  Torch's
generators give other numbers than ``jax.random`` from the same seed, so
the two packages agree in distribution, not in values.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer class under its lowercased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class Initializer:
    """Base initializer (parity: initializer.Initializer)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, tensor, generator=None):
        """Fill ``tensor`` (the parameter called ``name``) in place."""
        name = str(name)
        with torch.no_grad():
            if name.endswith("bias") or name.endswith("beta") \
                    or name.endswith("running_mean"):
                tensor.zero_()
            elif name.endswith("gamma") or name.endswith("running_var"):
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
    if isinstance(init, str):
        if init.lower() not in _INIT_REGISTRY:
            raise MXNetError("unknown initializer %r" % init)
        return _INIT_REGISTRY[init.lower()](**kwargs)
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
