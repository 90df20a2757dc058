"""Activation layers (the port's counterpart of
``mxnet_tpu/gluon/nn/activations.py``): each calls the op of
``ops/nn.py`` that the JAX package's layer calls."""
from __future__ import annotations

import torch

from ... import initializer as _init
from ...context import resolve
from ...ops import nn as _ops
from ..block import HybridBlock


class Activation(HybridBlock):
    """Parity: nn.Activation — act_type in relu/sigmoid/tanh/softrelu/
    softsign (and the op's gelu, silu, erf)."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act_type = activation

    def forward(self, x):
        return _ops._activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class LeakyReLU(HybridBlock):
    """Parity: nn.LeakyReLU(alpha)."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _ops._leaky_relu(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "LeakyReLU(%s)" % self._alpha


class PReLU(HybridBlock):
    """Parity: nn.PReLU — a learnable slope per channel (axis 1),
    ``Constant(0.25)`` unless ``alpha_initializer`` says otherwise."""

    def __init__(self, alpha_initializer=None, in_channels=1, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if alpha_initializer is None:
            alpha_initializer = _init.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,), init=alpha_initializer,
                device=resolve(device))

    def forward(self, x):
        return _ops._leaky_relu(x, self.alpha, act_type="prelu")


class ELU(HybridBlock):
    """Parity: nn.ELU(alpha)."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _ops._leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Parity: nn.SELU."""

    def forward(self, x):
        return _ops._leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """Parity: nn.GELU (the exact, erf form)."""

    def forward(self, x):
        return _ops._leaky_relu(x, act_type="gelu")


class Swish(HybridBlock):
    """Parity: nn.Swish(beta) — x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)
