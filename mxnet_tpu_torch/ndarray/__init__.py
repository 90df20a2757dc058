"""``mx.nd`` — the imperative tensor namespace.

Op functions are generated at import from the port's registry
(``ops/tensor.py``, ``ops/nn.py``, ``ops/optimizer_ops.py``), as the JAX package's ``ndarray/__init__.py`` does
from its own.
"""
from __future__ import annotations

from ..ops import nn as _nn  # noqa: F401  (registers the ops)
from ..ops import optimizer_ops as _opt  # noqa: F401
from ..ops import tensor as _t  # noqa: F401
from .ndarray import (  # noqa: F401
    NDArray, arange, array, concatenate, empty, full, load, moveaxis, ones,
    ones_like, save, shard, waitall, zeros, zeros_like,
)
from .register import populate as _populate

_populate(globals())
