"""Device-memory accounting: who owns the live device tensors?

The port's counterpart of the JAX package's ``telemetry/memdump.py``.
It keeps the surface the serving tier uses — :func:`tag`,
:func:`origin`, :func:`refresh`, :func:`peak_bytes` — over PyTorch:

- tags are weak references to tensors, recorded at the low-frequency
  allocation sites (arena pages, serving weights), never per op;
- :func:`refresh` sums the live tagged tensors by *origin* (``param`` /
  ``activation`` / ``kv_page`` / ``temp`` / ``grad``) and attributes
  the rest of ``torch.cuda.memory_allocated()`` to ``temp``;
- the peak is the larger of the tagged watermark and
  ``torch.cuda.max_memory_allocated()``.

Host (CPU) tensors are counted by their tags only: the CPU allocator
keeps no totals.  Exported as ``mxnet_device_bytes{origin}`` and
``mxnet_device_peak_bytes`` gauges at snapshot time.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref

import torch

from ..base import env_flag
from . import flight
from .metrics import gauge, register_collector
# safe here: telemetry/__init__ imports metrics and flight BEFORE
# memdump, and lockcheck needs exactly those
from ..testing import lockcheck as _lockcheck

__all__ = ["origin", "tag", "refresh", "peak_bytes"]

ORIGINS = ("param", "activation", "kv_page", "temp", "grad")

_ENABLED = env_flag("MXNET_MEMDUMP", True)

_origin_var = contextvars.ContextVar("mxnet_memdump_origin", default="temp")

_lock = _lockcheck.named_lock("telemetry.memdump")
_tags = {}          # id(tensor) -> dict(ref, origin, nbytes, cuda)
_seen_origins = set(ORIGINS)
_peak = 0


def _on_free(key):
    # A tensor's finalizer runs in whatever frees it, and that can be a
    # garbage collection started by an allocation while this thread
    # holds ``_lock`` (in ``_live_tags``): taking the lock here would
    # wait on itself forever.  ``dict.pop`` is atomic on its own.
    _tags.pop(key, None)


def tag(buf, origin=None, label=None):
    """Attribute tensor ``buf`` to an origin.  Called at allocation
    sites, NOT per op.  Returns the flight seq of the ``mem.tag`` event
    (or -1 when disabled / not a tensor)."""
    if not _ENABLED or not isinstance(buf, torch.Tensor):
        return -1
    o = origin or _origin_var.get()
    nbytes = buf.numel() * buf.element_size()
    seq = flight.record("mem.tag", origin=o, nbytes=nbytes,
                        label=label or "")
    key = id(buf)
    rec = {"ref": weakref.ref(buf), "origin": o, "nbytes": nbytes,
           "cuda": buf.is_cuda}
    with _lock:
        _tags[key] = rec
        _seen_origins.add(o)
    weakref.finalize(buf, _on_free, key)
    return seq


def _live_tags():
    """Tag records whose tensor is still alive (dead ones pruned)."""
    with _lock:
        items = list(_tags.items())
    live = []
    for key, rec in items:
        if rec["ref"]() is None:
            with _lock:
                _tags.pop(key, None)
        else:
            live.append(rec)
    return live


def _cuda_allocated():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.memory_allocated(), \
            torch.cuda.max_memory_allocated()
    return 0, 0


def refresh():
    """Recompute live device bytes, publish the gauges, advance the peak
    watermark.  Returns ``(by_origin, total_bytes)``."""
    global _peak
    by = dict.fromkeys(_seen_origins, 0)
    tagged_cuda = 0
    for rec in _live_tags():
        by[rec["origin"]] = by.get(rec["origin"], 0) + rec["nbytes"]
        if rec["cuda"]:
            tagged_cuda += rec["nbytes"]
    allocated, max_allocated = _cuda_allocated()
    by["temp"] = by.get("temp", 0) + max(0, allocated - tagged_cuda)
    total = sum(by.values())
    with _lock:
        _peak = max(_peak, total, max_allocated)
        peak = _peak
    for o, v in sorted(by.items()):
        gauge("mxnet_device_bytes", help="live device bytes by origin",
              origin=o).set(v)
    gauge("mxnet_device_peak_bytes",
          help="peak observed live device bytes (sampled at snapshots "
               "and explicit refresh)").set(peak)
    return by, total


def peak_bytes():
    """The peak watermark as of the last :func:`refresh`, or the CUDA
    allocator's own peak when that is higher."""
    with _lock:
        peak = _peak
    return max(peak, _cuda_allocated()[1])


register_collector(refresh)
