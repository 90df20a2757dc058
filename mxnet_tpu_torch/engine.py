"""Dependency engine over CUDA streams.

The port's counterpart of the JAX package's ``engine.py`` (reference:
``src/engine/``, an async scheduler with versioned variables and
read/write dependency queues).  On the card a CUDA stream already runs
the work enqueued on it in order, so pushing an op means enqueueing it on
torch's current stream and returning: a push never synchronizes.  What
the engine keeps:

* ``Var`` — a versioned variable (one per NDArray).  Each write bumps
  its version; a write pushed on a CUDA stream remembers that stream.
* exception poisoning — a push whose function raises poisons its write
  vars; the stored error is rethrown at the next push that reads one of
  them or at the next wait on it (parity: ``threaded_engine.cc:383-436``).
  This covers failures on the host side of a push.  A fault inside a
  kernel surfaces only at the next synchronization, as on any CUDA
  stream.
* ``wait_for_var`` — waits for the stream of the var's last write (or
  the device's current stream when the write was not pushed through a
  var); ``wait_for_all`` (``waitall``) is ``torch.cuda.synchronize()`` on
  every device the engine has seen.
* op hooks ``fn(op_name, t_start, t_end)`` on the host clock (the
  enqueue, not the device time), sync hooks ``fn(origin)``, ``stats``,
  the flight recorder's ``engine.push``/``engine.poison``/``engine.sync``
  events and the fault-injection site ``engine_push``.

Op bulking (the JAX package's ``BulkSegment`` and ``_try_bulk``) is not
ported: :func:`set_bulk_size` and :class:`bulk` exist with the reference
signatures and run every op eagerly, which gives the same results.
"""
from __future__ import annotations

import itertools
import time

import torch

from .telemetry import flight as _flight
from .telemetry import metrics as _metrics
from .testing.faults import maybe_inject as _inject

_var_ids = itertools.count(1)


class Var:
    """Versioned variable (parity: engine::Var, include/mxnet/engine.h:44)."""

    __slots__ = ("vid", "version", "stream", "_exc")

    def __init__(self):
        self.vid = next(_var_ids)
        self.version = 0
        self.stream = None      # CUDA stream of the last pushed write
        self._exc = None

    def on_write(self, stream=None):
        self.version += 1
        self.stream = stream

    def set_exception(self, exc):
        self._exc = exc

    def rethrow(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


class _Stats:
    __slots__ = ("ops_pushed", "sync_origins")

    def __init__(self):
        self.ops_pushed = 0
        self.sync_origins = {}   # device->host syncs by origin


class Engine:
    """Engine façade: ``push`` runs the op's host side now and enqueues its
    device work on torch's current stream."""

    _instance = None

    def __init__(self):
        self.stats = _Stats()
        self._hooks = []        # fn(op_name, t_start, t_end) per push
        self._sync_hooks = []   # fn(origin) per device->host sync
        self._devices = set()   # CUDA device indices work was pushed to
        self._bulk_max = 0

    @staticmethod
    def get():
        if Engine._instance is None:
            Engine._instance = Engine()
        return Engine._instance

    # -- push -------------------------------------------------------------
    def push(self, fn, read_vars=(), write_vars=(), op_name=None,
             device=None):
        """Run ``fn`` now (its kernels are enqueued, not waited for) and
        bump the write vars' versions.  ``device``, a ``torch.device``,
        names where the work runs: on a CUDA device the write vars
        remember the current stream.  A read var poisoned by an earlier
        failed push rethrows here; if ``fn`` raises, every write var is
        poisoned with the error, which is raised."""
        for v in read_vars:
            v.rethrow()
        self.stats.ops_pushed += 1
        _flight.record("engine.push", op=op_name or "op")
        t0 = time.perf_counter() if self._hooks else 0.0
        try:
            # chaos hook: an injected failure takes the same poisoning
            # path as a real one
            _inject("engine_push", op=op_name)
            out = fn()
        except Exception as e:
            _flight.record("engine.poison", op=op_name or "op",
                           error=type(e).__name__, writes=len(write_vars))
            for v in write_vars:
                v.set_exception(e)
            _flight.crash_dump("poison")
            raise
        if write_vars:
            stream = None
            if device is not None and device.type == "cuda":
                stream = torch.cuda.current_stream(device)
                self._devices.add(device.index or 0)
            for v in write_vars:
                v.on_write(stream)
        if self._hooks:
            t1 = time.perf_counter()
            for h in self._hooks:
                h(op_name or getattr(fn, "__name__", "op"), t0, t1)
        return out

    def track(self, data):
        """Note the device of a pushed op's output so ``wait_for_all``
        synchronizes it (a CUDA stream already orders the work itself)."""
        if data.is_cuda:
            self._devices.add(data.device.index or 0)

    # -- sync -------------------------------------------------------------
    def wait_for_var(self, var, device=None, origin="wait_for_var"):
        """Rethrow a poisoned var, then wait for its last write: the
        stream it was pushed on, else ``device``'s current stream (a
        host array has nothing to wait for)."""
        var.rethrow()
        self.notify_sync(origin)
        stream = var.stream
        if stream is None and device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
        if stream is not None:
            stream.synchronize()

    def wait_for_all(self):
        self.notify_sync("waitall")
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for d in sorted(self._devices) or [torch.cuda.current_device()]:
                torch.cuda.synchronize(d)

    # -- instrumentation --------------------------------------------------
    def add_hook(self, fn, kind="op"):
        """Register an instrumentation hook, idempotently: ``kind='op'``
        hooks get ``fn(op_name, t_start, t_end)`` after every push,
        ``kind='sync'`` hooks ``fn(origin)`` at every device->host sync."""
        hooks = self._hooks_of(kind)
        if fn not in hooks:
            hooks.append(fn)

    def remove_hook(self, fn, kind="op"):
        hooks = self._hooks_of(kind)
        if fn in hooks:
            hooks.remove(fn)

    def _hooks_of(self, kind):
        if kind == "op":
            return self._hooks
        if kind == "sync":
            return self._sync_hooks
        raise ValueError("unknown hook kind %r (want 'op' or 'sync')" % kind)

    def notify_sync(self, origin):
        """Report one device->host sync to the sync hooks."""
        _flight.record("engine.sync", origin=origin)
        if _metrics.enabled():
            so = self.stats.sync_origins
            so[origin] = so.get(origin, 0) + 1
        for h in self._sync_hooks:
            h(origin)


def _telemetry_collector():
    """Export the engine's counters at snapshot time."""
    eng = Engine._instance
    if eng is None:
        return
    _metrics.counter("mxnet_engine_ops_pushed_total",
                     help="ops dispatched through Engine.push"
                     ).set(eng.stats.ops_pushed)
    for origin, n in list(eng.stats.sync_origins.items()):
        _metrics.counter("mxnet_engine_sync_total",
                         help="device->host syncs by origin",
                         origin=origin).set(n)


_metrics.register_collector(_telemetry_collector)


def waitall():
    Engine.get().wait_for_all()


def set_bulk_size(size):
    """Set the segment cap (parity: mxnet.engine.set_bulk_size) and
    return the previous one.  The port runs every op eagerly whatever
    the cap: bulking is not ported."""
    eng = Engine.get()
    prev, eng._bulk_max = eng._bulk_max, int(size)
    return prev


class bulk:
    """Scope for bulking consecutive imperative ops (parity:
    mxnet.engine.bulk).  The port runs every op eagerly inside it, with
    the same results."""

    def __init__(self, size):
        self.size = int(size)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
