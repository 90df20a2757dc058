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

``Dense(activation=...)`` applies an ``Activation`` child (``act``) to
the product, in the product's dtype.

``LayerNorm``, ``GroupNorm`` and ``InstanceNorm`` call the ops of
``ops/nn.py``; their ``gamma`` and ``beta`` take their shape from the
first input when ``in_channels=0`` (in the dtype a ``cast`` gave them
before that), and one that ``scale=False`` or ``center=False`` turns off
takes no gradient (the JAX package's ``grad_req="null"``).  Under AMP
they compute in f32 and return f32, as the JAX package's do.

``Concurrent`` and ``HybridConcurrent`` run each child on the input and
concatenate the outputs along ``axis``.  ``Lambda`` and ``HybridLambda``
wrap a function or the name of a registered op; ``HybridLambda`` calls
a function as ``function(F, x, *args)``, where ``F.<op>`` is the
registered op on tensors (``ops.registry.invoke_raw``).

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

import numpy as np
import torch
import torch.nn.functional as F

from ... import amp as _amp
from ... import autograd as _autograd
from ... import layout as _layout
from ...base import MXNetError
from ...context import resolve
from ...ops import nn as _ops
from ...ops import registry as _registry
from ..block import Block, HybridBlock, as_dtype, cast_tensors
from .activations import Activation

_LAZY = torch.nn.parameter.UninitializedTensorMixin


class Sequential(Block):
    """Parity: nn.Sequential — children named ``0``, ``1``, ..."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        """The ``key``-th child; for a slice, a new block of this type
        holding those children (parity: Sequential.__getitem__)."""
        layers = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers[key])
            return net
        return layers[key]

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
        dev = resolve(device)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True,
                device=dev)
            self.bias = self.params.get(
                "bias", shape=(units,), dtype=dtype, init=bias_initializer,
                allow_deferred_init=True, device=dev) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _shape_hint(self, x, *args):
        p = self._reg_params["weight"]
        if p.shape and p.shape[1] == 0:
            in_units = int(np.prod(x.shape[1:])) if self._flatten \
                else x.shape[-1]
            p.shape = (self._units, in_units)

    def forward(self, x):
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        if isinstance(self.weight, _LAZY):
            self._finish_param("weight", (self._units, x.shape[-1]))
        x, w, b = _amp.transform_inputs("FullyConnected",
                                        (x, self.weight, self.bias))
        out = F.linear(x.to(w.dtype), w, b)
        return out if self.act is None else self.act(out)

    def __repr__(self):
        shape = tuple(self.weight.shape) if not isinstance(
            self.weight, torch.nn.parameter.UninitializedParameter) else None
        return "Dense(%s -> %s, %s)" % (
            shape[1] if shape else None, self._units,
            "linear" if self.act is None else self.act)


class Embedding(HybridBlock):
    """Parity: nn.Embedding — rows of an (input_dim, output_dim) table
    through the ``Embedding`` op: float indices (as the JAX package's
    ``nd.array`` batches carry them) are truncated to integers, a
    negative one counts from the end, and one out of range gives a row
    of NaN, as in the JAX package.  With ``sparse_grad=True`` a call that
    ``autograd.record()`` records clips the ids and gives the weight a
    row-sparse gradient (``ops.nn.embedding_rows``; ``weight.grad()`` is
    a ``RowSparseNDArray``, ``gluon.Trainer`` updates its rows lazily),
    also inside a hybridized block, whose recorded calls then run
    eagerly."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = bool(sparse_grad)
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True,
            grad_stype="row_sparse" if sparse_grad else "default",
            device=resolve(device))

    def forward(self, x):
        return _ops._embedding(x, self.weight, sparse_grad=self._sparse_grad)

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
        _affine_params(self, in_channels, dev, center, scale,
                       beta_initializer, gamma_initializer)
        for name, init in (("running_mean", running_mean_initializer),
                           ("running_var", running_variance_initializer)):
            p = self.params.get(name, grad_req="null", shape=(in_channels,),
                                init=init, allow_deferred_init=True,
                                device=dev)
            self._register_handle(name, p, buffer=True)
            if in_channels > 0:
                p.initialize()

    _NAMES = ("gamma", "beta", "running_mean", "running_var")

    def _tensors(self):
        return (self.gamma, self.beta, self.running_mean, self.running_var)

    def _shape_hint(self, x, *args):
        if self._reg_params["gamma"].shape[0] == 0:
            for name in self._NAMES:
                self._reg_params[name].shape = (x.shape[self._axis],)

    def _materialize(self, channels):
        for name in self._NAMES:
            self._finish_param(name, (channels,))

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


def _affine_params(block, in_channels, device, center, scale,
                   beta_initializer, gamma_initializer):
    """A norm's ``gamma`` and ``beta`` (``in_channels`` each, or deferred
    when it is 0), each taking a gradient only when ``scale`` or
    ``center`` turns it on (else ``grad_req="null"``)."""
    for name, init, grad in (("gamma", gamma_initializer, scale),
                             ("beta", beta_initializer, center)):
        setattr(block, name, block.params.get(
            name, grad_req="write" if grad else "null",
            shape=(in_channels,), init=init, allow_deferred_init=True,
            device=device))


class _Norm(HybridBlock):
    """A norm over ``gamma`` and ``beta`` of one channel axis, deferred
    or not (LayerNorm, GroupNorm, InstanceNorm)."""

    def __init__(self, axis, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, prefix, params, device):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        _affine_params(self, in_channels, resolve(device), center, scale,
                       beta_initializer, gamma_initializer)

    def _shape_hint(self, x, *args):
        if self._reg_params["gamma"].shape[0] == 0:
            for name in ("gamma", "beta"):
                self._reg_params[name].shape = (x.shape[self._axis],)

    def forward(self, x):
        if isinstance(self.gamma, _LAZY):
            for name in ("gamma", "beta"):
                self._finish_param(name, (x.shape[self._axis],))
        return self._norm(x)


class LayerNorm(_Norm):
    """Parity: nn.LayerNorm — over ``axis`` (default the last)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(axis, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params,
                         device)

    def _norm(self, x):
        return _ops._layer_norm(x, self.gamma, self.beta, axis=self._axis,
                                eps=self._epsilon)

    def __repr__(self):
        return "LayerNorm(axis=%s, eps=%s)" % (self._axis, self._epsilon)


class GroupNorm(_Norm):
    """Parity: nn.GroupNorm — the channels (axis 1) in ``num_groups``
    groups."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params,
                         device)
        self._num_groups = num_groups

    def _norm(self, x):
        return _ops._group_norm(x, self.gamma, self.beta,
                                num_groups=self._num_groups,
                                eps=self._epsilon)


class InstanceNorm(_Norm):
    """Parity: nn.InstanceNorm — each channel (axis 1) of each sample;
    ``axis`` is accepted as in the JAX package, which also normalizes
    over the axes after axis 1."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None):
        del axis
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params,
                         device)

    def _norm(self, x):
        return _ops._instance_norm(x, self.gamma, self.beta,
                                   eps=self._epsilon)


def _concat(outs, axis):
    """The outputs along ``axis`` in their widest dtype (``concat`` is on
    AMP's widest-type list; torch promotes the same way)."""
    return torch.cat(_amp.transform_inputs("concat", outs), dim=axis)


class Concurrent(Sequential):
    """Parity: nn.Concurrent — each child on the same input, the outputs
    concatenated along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return _concat([block(x) for block in self._modules.values()],
                       self.axis)


class HybridConcurrent(HybridSequential):
    """Parity: nn.HybridConcurrent — a ``Concurrent`` that
    ``hybridize()`` runs as captured CUDA graphs."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return _concat([block(x) for block in self._modules.values()],
                       self.axis)


def _registered(name):
    """The registered op ``name`` on tensors, as a layer runs it: one
    tensor or a tuple."""
    def op(*datas, **attrs):
        outs = _registry.invoke_raw(name, datas, attrs, push=False)[0]
        return outs[0] if len(outs) == 1 else outs
    return op


class _Ops:
    """``F`` of a ``HybridLambda``'s function: ``F.<name>(*tensors,
    **attrs)`` runs the registered op ``name`` on tensors."""

    def __getattr__(self, name):
        _registry.get(name)
        return _registered(name)


def _op_function(function):
    """``(function, name)`` from a callable or a registered op's name."""
    if isinstance(function, str):
        try:
            _registry.get(function)
        except MXNetError:
            raise MXNetError("function %s not found in mx.nd" % function)
        return _registered(function), function
    if callable(function):
        return function, getattr(function, "__name__", "lambda")
    raise MXNetError("function must be str or callable")


class Lambda(Block):
    """Parity: nn.Lambda — ``function(*inputs)``, or the registered op of
    that name."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func, self._func_name = _op_function(function)

    def forward(self, *args):
        return self._func(*args)

    def __repr__(self):
        return "Lambda(%s)" % self._func_name


class HybridLambda(HybridBlock):
    """Parity: nn.HybridLambda — ``function(F, x, *args)``, or the
    registered op of that name on ``(x, *args)``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func, self._func_name = _op_function(function)
        self._takes_f = not isinstance(function, str)

    def forward(self, x, *args):
        if self._takes_f:
            return self._func(_Ops(), x, *args)
        return self._func(x, *args)

    def __repr__(self):
        return "HybridLambda(%s)" % self._func_name
