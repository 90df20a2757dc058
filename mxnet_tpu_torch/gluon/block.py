"""Blocks: ``Block`` and ``HybridBlock`` as ``torch.nn.Module``s.

The port's counterpart of ``mxnet_tpu/gluon/block.py``.  A block is a
module whose ``forward`` is plain torch; the JAX package's
``hybrid_forward(F, ...)`` dispatch does not exist here.  Parameters are
``torch.nn.Parameter``s named by structure (``blocks.0.attn.q_proj.weight``),
which are the JAX package's ``_collect_params_with_prefix()`` names, so
``state_dict()`` keys equal them.  A parameter may carry an ``init``
attribute (``"ones"``, ``"zeros"`` or an ``Initializer``) that overrides
the initializer given to ``initialize``, as in the JAX package.
"""
from __future__ import annotations

import torch

from .. import initializer as _init
from ..base import MXNetError
from ..context import resolve

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def as_dtype(dtype):
    """A ``torch.dtype`` from a dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise MXNetError("unsupported dtype %r (one of %s)"
                         % (dtype, sorted(_DTYPES)))


def new_param(shape, device, dtype="float32", init=None):
    """An uninitialized parameter (filled by ``Block.initialize``)."""
    p = torch.nn.Parameter(torch.empty(shape, dtype=as_dtype(dtype),
                                       device=resolve(device)))
    p.init = init
    return p


class Block(torch.nn.Module):
    """Base block (parity: gluon.Block).  ``prefix``/``params`` are
    accepted for the JAX package's signatures; names are structural."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        del prefix, params
        self._deferred_init = None    # (init, generator) for lazy shapes

    def collect_params(self):
        """``{structural name: Parameter}`` in registration order."""
        return dict(self.named_parameters())

    def initialize(self, init=None, device=None, verbose=False,
                   force_reinit=False, generator=None):
        """Fill every parameter from ``init`` (default ``Uniform()``), or
        from the parameter's own ``init`` where it has one, drawing from
        ``generator``.  A parameter initialized before is left alone
        unless ``force_reinit``.  Parameters whose shape is known only at
        the first forward (``Dense(in_units=0)``) are filled then.
        ``device`` is accepted for parity: parameters live where their
        block was built."""
        del device, verbose
        default = _init.create(init)
        for module in self.modules():
            module._deferred_init = (default, generator)
        for name, p in self.named_parameters():
            if isinstance(p, torch.nn.parameter.UninitializedParameter):
                continue
            if getattr(p, "_initialized", False) and not force_reinit:
                continue
            fill_param(name, p, default, generator)
        return self

    def cast(self, dtype):
        """Cast every floating-point parameter to ``dtype`` (parity:
        Block.cast, which ``amp.convert_hybrid_block`` uses)."""
        dt = as_dtype(dtype)
        for p in self.parameters():
            if p.is_floating_point() and not isinstance(
                    p, torch.nn.parameter.UninitializedParameter):
                p.data = p.data.to(dt)
        return self

    def hybridize(self, active=True, **kwargs):
        """A no-op kept for parity: the port runs eagerly, and nothing
        is traced or compiled (the JAX package compiles one executable
        here)."""
        return self


class HybridBlock(Block):
    """Parity: gluon.HybridBlock — the same as ``Block`` in the port."""


def fill_param(name, p, default, generator):
    """Initialize ``p`` in place from its own ``init`` or ``default``."""
    own = getattr(p, "init", None)
    initializer = _init.create(own) if own is not None else default
    with torch.no_grad():
        initializer(name, p.data, generator=generator)
    p._initialized = True
