"""Device contexts: ``Context``, ``gpu(i)``, ``cpu()`` and ``resolve``.

The port's counterpart of the JAX package's ``context.py``.  A
``Context`` names a logical device (``device_type`` ``"gpu"`` or
``"cpu"``, ``device_id``) and resolves to a ``torch.device``
(:attr:`Context.torch_device`).  ``with ctx:`` makes it the default of
the calling thread; :func:`current_context` reads that default.

Deliberate deviation: the default context is ``gpu(0)``, not the CPU.
Asking for a card on a machine without CUDA raises instead of quietly
running on the host — a host run is asked for (``ctx=mx.cpu()``,
``with mx.cpu():`` or ``device="cpu"``), as the tests do.

Where the two return types meet: ``gpu()`` and ``cpu()`` return a
``Context``, which compares equal to the ``torch.device`` it names.  The
entry points of the serving and training tiers take a ``device``
argument and pass it to :func:`resolve`, which accepts a ``Context``, a
``torch.device``, a string or ``None`` and returns the ``torch.device``;
the NDArray frontend takes ``ctx=`` in any of those forms and keeps a
``Context``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

_DEVTYPE2ID = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}
_default = threading.local()


class Context:
    """A logical device: ``Context("gpu", 0)`` is the first CUDA card,
    ``Context("cpu")`` the host.  ``"cuda"`` is accepted for ``"gpu"``.
    Equality and hashing go by ``(device_type, device_id)``; a Context
    also compares equal to the ``torch.device`` it names."""

    __slots__ = ("device_type", "device_id", "_old")

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in _DEVTYPE2ID:
            raise MXNetError("unknown device type %r (gpu, cpu or "
                             "cpu_pinned)" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id) if device_type == "gpu" else 0
        self._old = []

    @property
    def device_typeid(self):
        return _DEVTYPE2ID[self.device_type]

    @property
    def torch_device(self):
        """The ``torch.device``; a ``gpu`` context checks that the card
        exists."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        _check_gpu(self.device_id)
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        if isinstance(other, torch.device):
            other = Context.from_device(other)
        return isinstance(other, Context) and \
            (self.device_type, self.device_id) == \
            (other.device_type, other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        self._old.append(getattr(_default, "value", None))
        _default.value = self
        return self

    def __exit__(self, *exc):
        _default.value = self._old.pop()

    def empty_cache(self):
        """Release the card's cached, unused memory (parity:
        Context.empty_cache); nothing on the host."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()

    @staticmethod
    def from_device(dev):
        """The Context of a ``torch.device`` (no check that it exists)."""
        if dev.type == "cuda":
            return Context("gpu", 0 if dev.index is None else dev.index)
        if dev.type == "cpu":
            return Context("cpu")
        raise MXNetError("unsupported device %r (cuda or cpu)" % (dev,))


def _check_gpu(device_id):
    if not torch.cuda.is_available():
        raise MXNetError(
            "gpu(%d) requested but CUDA is not available — pass "
            "device='cpu' (or ctx=mx.cpu()) to run on the host" % device_id)
    n = torch.cuda.device_count()
    if not 0 <= int(device_id) < n:
        raise MXNetError("gpu(%d) requested but only %d CUDA device(s) "
                         "are visible" % (device_id, n))


def gpu(device_id=0):
    """The ``device_id``-th CUDA card; raises when CUDA is absent."""
    _check_gpu(device_id)
    return Context("gpu", device_id)


def cpu(device_id=0):
    """The host (the index is accepted for MXNet parity and ignored)."""
    return Context("cpu")


def cpu_pinned(device_id=0):
    """The host, as MXNet's page-locked context names it (parity:
    context.cpu_pinned): arrays on it are host tensors, like ``cpu()``'s."""
    return Context("cpu_pinned")


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_context():
    """The calling thread's default: the innermost ``with ctx:``, else
    ``gpu(0)`` (which raises without CUDA)."""
    ctx = getattr(_default, "value", None)
    return ctx if ctx is not None else gpu(0)


current_context = default_context


def as_context(ctx=None):
    """``None`` → :func:`current_context`; a Context, ``torch.device`` or
    string → its Context (a ``gpu`` one checked to exist)."""
    if ctx is None:
        return current_context()
    if not isinstance(ctx, Context):
        ctx = Context.from_device(torch.device(ctx))
    if ctx.device_type == "gpu":
        _check_gpu(ctx.device_id)
    return ctx


def resolve(device=None):
    """``None`` → the current context's device (``cuda:0`` unless a
    ``with mx.cpu():`` scope says otherwise); a Context, string or
    ``torch.device`` is checked the same way (a CUDA device must exist).
    Returns the ``torch.device``."""
    if device is None:
        return current_context().torch_device
    if isinstance(device, Context):
        return device.torch_device
    dev = torch.device(device)
    if dev.type in ("cuda", "cpu"):
        return Context.from_device(dev).torch_device
    raise MXNetError("unsupported device %r (cuda or cpu)" % (device,))
