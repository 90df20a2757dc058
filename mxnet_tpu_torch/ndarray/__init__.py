"""``mx.nd`` — the imperative tensor namespace.

Op functions are generated at import from the port's registry
(``ops/tensor.py``, ``ops/nn.py``, ``ops/random_ops.py``,
``ops/optimizer_ops.py``), as the JAX package's ``ndarray/__init__.py``
does from its own; ``nd.random`` holds the samplers and ``nd.contrib``
the ``_contrib_*`` ops under their short names.
"""
from __future__ import annotations

from ..ops import nn as _nn  # noqa: F401  (registers the ops)
from ..ops import optimizer_ops as _opt  # noqa: F401
from ..ops import random_ops as _r  # noqa: F401
from ..ops import tensor as _t  # noqa: F401
from .ndarray import (  # noqa: F401
    NDArray, arange, array, concatenate, empty, full, load, moveaxis, ones,
    ones_like, save, shard, waitall, zeros, zeros_like,
)
from . import random  # noqa: F401
from .register import populate as _populate

_populate(globals())


class _ContribNS:
    """``nd.contrib.<name>``: the op ``_contrib_<name>``."""

    def __getattr__(self, item):
        fn = globals().get("_contrib_" + item)
        if fn is None:
            raise AttributeError("nd.contrib.%s" % item)
        return fn

    def __dir__(self):
        return sorted(n[len("_contrib_"):] for n in globals()
                      if n.startswith("_contrib_"))


contrib = _ContribNS()
