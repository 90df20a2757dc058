"""Basic layers (the port's counterpart of ``gluon/nn/basic_layers.py``).

``Dense`` keeps the MXNet arguments and the (units, in_units) weight
layout of the JAX package; with ``in_units=0`` its weight's shape is
taken from the first input, and it is filled then with the initializer
that ``initialize`` was given.  Every layer takes ``device=`` (default
``cuda:0``, resolved by ``context.resolve``).

Dtypes follow the JAX package under AMP: a ``Dense`` runs in its
weight's dtype, or under ``amp.init`` in the target dtype
(``FullyConnected`` is on AMP's target list), so a bf16 layer casts an
f32 input down.

``BatchNorm`` keeps ``gamma`` and ``beta`` as parameters and the running
statistics as buffers (``running_mean``, ``running_var``: the JAX
package's ``grad_req="null"`` parameters, under the same names); a
train-mode forward (``autograd.is_training()``) writes the new
statistics into them in place, so a captured graph's replay updates
them.  With ``in_channels=0`` all four take their shape from the first
input.  Under ``cast`` to bf16 or f16 all four stay f32, as in the JAX
package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import amp as _amp
from ... import autograd as _autograd
from ... import initializer as _init
from ... import layout as _layout
from ...base import MXNetError
from ...context import resolve
from ...ops import nn as _ops
from ..block import (Block, HybridBlock, as_dtype, cast_tensors, fill_param,
                     new_param)

_LAZY = torch.nn.parameter.UninitializedTensorMixin


class Sequential(Block):
    """Parity: nn.Sequential — children named ``0``, ``1``, ..."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(Sequential, HybridBlock):
    """Parity: nn.HybridSequential — a ``Sequential`` that
    ``hybridize()`` runs as captured CUDA graphs."""


class Dense(HybridBlock):
    """Fully-connected layer: ``y = x W^T + b`` with W (units, in_units).

    ``flatten=True`` folds every axis after the first into the input
    features; ``flatten=False`` applies the layer to the last axis."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if activation is not None:
            raise MXNetError("Dense(activation=...) is not ported; apply "
                             "the activation after the layer")
        dev = resolve(device)
        self._units = units
        self._flatten = flatten
        if in_units > 0:
            self.weight = new_param((units, in_units), dev, dtype,
                                    weight_initializer)
        else:
            self.weight = torch.nn.parameter.UninitializedParameter(
                device=dev, dtype=as_dtype(dtype))
            self.weight.init = weight_initializer
        self.bias = new_param((units,), dev, dtype, bias_initializer) \
            if use_bias else None

    def _materialize(self, in_units):
        init = self.weight.init
        self.weight.materialize((self._units, in_units))
        self.weight.init = init
        if self._deferred_init is None:
            raise MXNetError("Dense: call initialize() before the first "
                             "forward")
        fill_param("weight", self.weight, *self._deferred_init)

    def forward(self, x):
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        if isinstance(self.weight, torch.nn.parameter.UninitializedParameter):
            self._materialize(x.shape[-1])
        x, w, b = _amp.transform_inputs("FullyConnected",
                                        (x, self.weight, self.bias))
        return F.linear(x.to(w.dtype), w, b)

    def __repr__(self):
        shape = tuple(self.weight.shape) if not isinstance(
            self.weight, torch.nn.parameter.UninitializedParameter) else None
        return "Dense(%s -> %s)" % (shape[1] if shape else None, self._units)


class Embedding(HybridBlock):
    """Parity: nn.Embedding — rows of an (input_dim, output_dim) table.
    Float indices (as the JAX package's ``nd.array`` batches carry them)
    are taken as integers."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True) is not ported")
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = new_param((input_dim, output_dim), device, dtype,
                                weight_initializer)

    def forward(self, x):
        return F.embedding(x.long(), self.weight)

    def __repr__(self):
        return "Embedding(%s -> %s)" % (self._input_dim, self._output_dim)


class Flatten(HybridBlock):
    """Parity: nn.Flatten — every axis after the first into one."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def __repr__(self):
        return "Flatten"


class Identity(HybridBlock):
    """Parity: nn.Identity."""

    def forward(self, x):
        return x


class Dropout(HybridBlock):
    """Parity: nn.Dropout — active only in train mode
    (``autograd.is_training()``); the mask is drawn from ``generator``
    (default: torch's on the input's device)."""

    def __init__(self, rate, axes=(), prefix=None, params=None,
                 generator=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)
        self._generator = generator

    def forward(self, x):
        if self._rate == 0:
            return x
        return _ops._dropout(
            x, p=self._rate, axes=self._axes, generator=self._generator,
            _mode="train" if _autograd.is_training() else "predict")

    def __repr__(self):
        return "Dropout(p = %s, axes=%s)" % (self._rate, self._axes)


class BatchNorm(HybridBlock):
    """Parity: nn.BatchNorm — the running statistics are updated in place
    on each train-mode forward (``autograd.is_training()``), through the
    JAX package's ``BatchNorm`` op (``ops/nn.py``).  ``axis=None`` is 1,
    or -1 under a channels-last layout policy or scope."""

    def __init__(self, axis=None, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if axis is None:
            axis = -1 if _layout.is_channel_last() else 1
        self._axis = axis
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        dev = resolve(device)
        shape = (in_channels,) if in_channels > 0 else None
        for name, init, grad in (("gamma", gamma_initializer, scale),
                                 ("beta", beta_initializer, center)):
            if shape:
                p = new_param(shape, dev, init=init).requires_grad_(grad)
            else:
                p = torch.nn.parameter.UninitializedParameter(
                    requires_grad=grad, device=dev, dtype=torch.float32)
                p.init = init
            setattr(self, name, p)
        for name, init in (("running_mean", running_mean_initializer),
                           ("running_var", running_variance_initializer)):
            b = torch.empty(shape, device=dev) if shape else \
                torch.nn.parameter.UninitializedBuffer(device=dev)
            b.init = init
            self.register_buffer(name, b)
            if shape:
                _init.create(init)(name, b)
                b._initialized = True

    def _tensors(self):
        return (self.gamma, self.beta, self.running_mean, self.running_var)

    def _materialize(self, channels):
        if self._deferred_init is None:
            raise MXNetError("BatchNorm: call initialize() before the first "
                             "forward")
        for name, t in zip(("gamma", "beta", "running_mean", "running_var"),
                           self._tensors()):
            init = t.init
            t.materialize((channels,))
            t.init = init
            if name.startswith("running"):
                _init.create(init)(name, t)
                t._initialized = True
            else:
                fill_param(name, t, *self._deferred_init)

    def cast(self, dtype):
        """Cast to ``dtype``, but keep f32 under bf16 and f16: the
        statistics and the per-channel scale stay f32 (parity:
        basic_layers.py BatchNorm.cast)."""
        if as_dtype(dtype) in (torch.bfloat16, torch.float16):
            dtype = "float32"
        super().cast(dtype)
        cast_tensors(self._buffers.values(), as_dtype(dtype))
        return self

    def forward(self, x):
        if isinstance(self.gamma, _LAZY):
            self._materialize(x.shape[self._axis])
        train = _autograd.is_training()
        out, mean, var = _ops._batch_norm(
            x, *self._tensors(), _mode="train" if train else "predict",
            **self._kwargs)
        if train and mean is not self.running_mean:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return out

    def __repr__(self):
        c = None if isinstance(self.gamma, _LAZY) else self.gamma.shape[0]
        return "BatchNorm(axis=%s, in_channels=%s)" % (self._axis, c)
