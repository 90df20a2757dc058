"""Automatic symbol naming: NameManager / Prefix.

Parity: ``python/mxnet/name.py`` (NameManager:25, Prefix:93).  The
reference generates canonical names for anonymous symbols
("fullyconnected0", ...) through a thread-local manager stack users can
override::

    with mx.name.Prefix("resnet_"):
        fc = mx.sym.FullyConnected(x, num_hidden=10)  # resnet_fullyconnected0

The symbol layer's auto-namer (``symbol/symbol.py _auto_name``) resolves
through ``NameManager.current()``; the default manager reproduces the
reference's per-hint counters.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]

_current = threading.local()
_default = None  # lazily-created PROCESS-wide fallback manager


class NameManager:
    """Per-hint counter naming (the reference's default behavior).

    Subclass and override :meth:`get` to change naming; install with a
    ``with`` block (managers nest, restoring the outer one on exit).
    """

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        """Canonical name: the user's ``name`` if given, else
        ``<hint><n>`` with a per-hint counter."""
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    @staticmethod
    def current():
        """The installed manager for this thread, else the PROCESS-wide
        default.  Scoped managers (``with`` blocks) are thread-local
        like the reference's; the fallback is shared so auto-names stay
        unique across threads (callers serialize via the symbol layer's
        name lock)."""
        mgr = getattr(_current, "value", None)
        if mgr is not None:
            return mgr
        global _default
        if _default is None:
            _default = NameManager()
        return _default

    def __enter__(self):
        self._old_manager = NameManager.current()
        _current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_manager is not None
        _current.value = self._old_manager
        return False


class Prefix(NameManager):
    """Attach a prefix to every auto-generated name (reference
    ``name.py:93``)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
