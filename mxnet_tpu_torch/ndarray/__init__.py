"""``mx.nd`` — the imperative tensor namespace.

Op functions are generated at import from the port's registry
(``ops/tensor.py``, ``ops/nn.py``, ``ops/random_ops.py``,
``ops/optimizer_ops.py``, ``ops/contrib.py``, ``ops/vision.py``,
``ops/misc.py``, ``ops/control_flow.py``, ``ops/quantized_ops.py``,
``ops/npi.py`` and the attention ops), as the
JAX package's ``ndarray/__init__.py`` does from its own; ``nd.random``
holds the samplers, ``nd.contrib`` the ``_contrib_*`` ops under their
short names with ``foreach``, ``while_loop`` and ``cond``, and
``nd.Custom`` runs the ops of ``mx.operator``.
"""
from __future__ import annotations

from ..ops import nn as _nn  # noqa: F401  (registers the ops)
from ..ops import optimizer_ops as _opt  # noqa: F401
from ..ops import random_ops as _r  # noqa: F401
from ..ops import tensor as _t  # noqa: F401
from ..ops import contrib as _c  # noqa: F401
from ..ops import flash_attention as _fa  # noqa: F401
from ..ops import paged_attention as _pa  # noqa: F401
from ..ops import misc as _m  # noqa: F401
from ..ops import vision as _v  # noqa: F401
from ..ops import control_flow as _cf  # noqa: F401
from ..ops import quantized_ops as _q  # noqa: F401
from ..ops import npi as _npi  # noqa: F401
from .ndarray import (  # noqa: F401
    NDArray, arange, array, concatenate, empty, full, load, moveaxis, ones,
    ones_like, save, shard, waitall, zeros, zeros_like,
)
from . import random  # noqa: F401
from .register import populate as _populate

_populate(globals())

# control flow (ops/control_flow.py) as nd.contrib.foreach/while_loop/cond
from ..ops.control_flow import (  # noqa: E402
    foreach as _contrib_foreach,
    while_loop as _contrib_while_loop,
    cond as _contrib_cond,
)

# user-defined ops (mx.operator; parity: mx.nd.Custom)
from ..operator import custom as Custom  # noqa: E402,F401


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
