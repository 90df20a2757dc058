"""Basic layers (the port's counterpart of ``gluon/nn/basic_layers.py``).

``Dense`` keeps the MXNet arguments and the (units, in_units) weight
layout of the JAX package; with ``in_units=0`` its weight's shape is
taken from the first input, and it is filled then with the initializer
that ``initialize`` was given.  Every layer takes ``device=`` (default
``cuda:0``, resolved by ``context.resolve``).

Dtypes follow the JAX package under AMP: a ``Dense`` runs in its
weight's dtype (``FullyConnected`` is on AMP's bf16 list), so a bf16
layer casts an f32 input down.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...base import MXNetError
from ...context import resolve
from ..block import Block, HybridBlock, as_dtype, fill_param, new_param


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
        w = self.weight
        return F.linear(x.to(w.dtype), w, self.bias)

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
