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
* op bulking (the reference's ``MXNET_EXEC_BULK_EXEC_*`` segments):
  under the default ``BulkEngine`` consecutive deferrable ops join this
  thread's open :class:`BulkSegment` (``ops.registry._try_bulk``) and
  return lazy NDArrays whose shape and dtype are known; the segment
  flushes as ONE push at a sync point, at the node cap or before a
  non-deferrable op.  On the card each segment key is a captured CUDA
  graph (``graph_cache.CapturedCall``, or the graph pair
  ``RecordedCall`` when autograd records it): eager the first time,
  captured the second, replayed after.  On the host the flush runs the
  ops in order.  The knobs are the JAX package's: ``MXNET_ENGINE_TYPE``
  (default ``BulkEngine``), ``MXNET_EXEC_BULK_EXEC_MAX_NODE`` (64),
  ``MXNET_EXEC_BULK_EXEC_TRAIN``/``_INFERENCE``, ``MXNET_PROFILE_BULK``
  and ``MXNET_EXEC_BULK_SEG_CACHE_BUDGETS``.  ``MXNET_EXEC_BULK_DONATE``
  is accepted and means nothing: a graph's pool reuses its memory.
"""
from __future__ import annotations

import collections
import itertools
import os
import sys
import threading
import time

import torch

from . import graph_cache as _graph_cache
from .base import MXNetError, env_flag
from .telemetry import flight as _flight
from .telemetry import metrics as _metrics
from .testing.faults import maybe_inject as _inject

_var_ids = itertools.count(1)

# the autograd module, bound on first use by Engine.bulk_size
_autograd = None


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
    __slots__ = ("ops_pushed", "bulk_ops", "bulk_segments", "sync_origins",
                 "flush_origins")

    def __init__(self):
        self.ops_pushed = 0
        self.bulk_ops = 0       # ops that ran inside a bulk segment
        self.bulk_segments = 0  # segments flushed (each one push)
        self.sync_origins = {}   # device->host syncs by origin
        self.flush_origins = {}  # segment flushes by origin kind


# ----------------------------------------------------------------------------
# op bulking (reference: MXNET_EXEC_BULK_EXEC_* segments)
# ----------------------------------------------------------------------------

# Segment executables keyed by the op sequence (op name, attrs, wiring,
# recording) and the external inputs' (shape, dtype, device,
# requires_grad), bucketed by segment length into tiers, each with its
# own LRU budget (the reference's tiers and budgets).  The tiers are per
# thread: on the card an executable holds CUDA graphs over one thread's
# stream and pool.
_SEG_TIER_BOUNDS = (8, 16, 32, 64)
_SEG_TIER_LABELS = ("le8", "le16", "le32", "le64")


def _parse_tier_budgets():
    vals = [128, 64, 32, 32]
    raw = os.environ.get("MXNET_EXEC_BULK_SEG_CACHE_BUDGETS", "").strip()
    if raw:
        try:
            parts = [int(p) for p in raw.split(",")]
        except ValueError:
            parts = []
        for i, p in enumerate(parts[: len(vals)]):
            if p > 0:
                vals[i] = p
    return tuple(vals)


_SEG_TIER_BUDGETS = _parse_tier_budgets()
_seg_tier_stats = tuple({"hits": 0, "misses": 0, "evictions": 0}
                        for _ in _SEG_TIER_BOUNDS)
_build_count = [0]


def _tier_index(n_ops):
    for i, bound in enumerate(_SEG_TIER_BOUNDS):
        if n_ops <= bound:
            return i
    return len(_SEG_TIER_BOUNDS) - 1


def bulk_build_count():
    """How many segment executables were built (tier cache misses): the
    probe for "a repeated op stream rebuilds nothing"."""
    return _build_count[0]


def _segment_fn(steps):
    """One callable running every deferred step in push order over the
    external inputs; returns every produced value, so its signature
    depends on the op sequence only, never on which outputs are still
    referenced (the reference keeps cache hits independent of GC)."""
    steps = tuple(steps)

    def run(*ext):
        vals = []
        for run_fn, slots, _n_out, recorded in steps:
            args = [vals[i] if kind == "v" else ext[i] for kind, i in slots]
            with torch.set_grad_enabled(recorded):
                outs = run_fn(*args)
            # as Engine.push's callers do: each result owns its tensor
            vals.extend(o.clone() if any(o is a for a in args) else o
                        for o in outs)
        return tuple(vals)

    return run


class _BulkRef:
    """A promised output of a not-yet-flushed segment (a lazy NDArray's
    value): its shape, dtype and whether it will require grad are known
    from the op's meta run."""

    __slots__ = ("segment", "index", "shape", "dtype", "requires_grad",
                 "device", "value", "failed")

    def __init__(self, segment, index, meta, device):
        self.segment = segment
        self.index = index
        self.shape, self.dtype, self.requires_grad = meta
        self.device = device
        self.value = None       # the tensor, after the flush
        self.failed = False     # the flush raised; no value will come

    def resolve(self):
        """The value, flushing the segment first if it has not run."""
        if self.value is None and not self.failed \
                and not self.segment.flushed:
            self.segment.flush("read")
        if self.value is None:
            raise MXNetError(
                "deferred NDArray lost: the bulk segment computing it "
                "failed (its error was raised at an earlier read)")
        return self.value


def _executable(fn, device, recorded, stream, pool, label, stable):
    """What runs one segment key: on the card a captured call in the
    thread's shared ``pool``, or the graph pair (in a pool of its own)
    when autograd records the segment, reading the ``stable`` external
    inputs (weights, gradient buffers) in place and copying the others
    into static buffers; on the host ``fn`` itself, which runs the steps
    in order."""
    if device.type != "cuda":
        return fn
    if recorded:
        return _graph_cache.RecordedCall(fn, device, stream=stream,
                                         label=label, inplace=stable)
    return _graph_cache.CapturedCall(fn, device, stream=stream, pool=pool,
                                     label=label, inplace=stable)


class BulkSegment:
    """A deferred run of consecutive imperative ops, flushed as ONE push.

    Built by ``ops.registry._try_bulk`` (which owns op semantics: attrs,
    fields, meta shapes) and run here (one ``Engine.push``, var
    poisoning, stats).  ``device`` is where every op of the segment
    runs."""

    __slots__ = ("engine", "cap", "device", "steps", "key_parts", "ext",
                 "_ext_ids", "_ext_storage", "stable", "refs", "write_vars",
                 "flushed", "n_ops", "taped")

    def __init__(self, engine, cap, device):
        self.engine = engine
        self.cap = cap            # flush after this many ops (0: no cap)
        self.device = device
        self.steps = []           # (run_fn, slots, n_out, recorded)
        self.key_parts = []       # hashable mirror of steps -> cache key
        self.ext = []             # external tensors, by identity
        self._ext_ids = {}
        self._ext_storage = set()  # their storages' data pointers
        self.stable = []          # per ext: a weight or gradient buffer
        self.refs = []            # _BulkRef per produced value, in order
        self.write_vars = []      # vars of the arrays built on refs
        self.flushed = False
        self.n_ops = 0
        self.taped = False        # some op is recorded by autograd

    def defer(self, step_key, run_fn, handles, metas, recorded):
        """Append one op.  ``handles`` are ``("v", _BulkRef)`` for a
        value of this segment or ``("x", tensor, stable)`` for an
        external one (``stable``: a weight's or a gradient buffer's
        tensor, which a graph reads in place); returns one ``_BulkRef``
        per output."""
        slots = []
        for handle in handles:
            kind, h = handle[0], handle[1]
            if kind == "v":
                slots.append(("v", h.index))
                continue
            i = self._ext_ids.get(id(h))
            if i is None:
                i = self._ext_ids[id(h)] = len(self.ext)
                self.ext.append(h)
                self.stable.append(bool(handle[2]))
                self._ext_storage.add(_storage_ptr(h))
            slots.append(("x", i))
        slots = tuple(slots)
        base = len(self.refs)
        refs = [_BulkRef(self, base + j, m, self.device)
                for j, m in enumerate(metas)]
        self.refs.extend(refs)
        self.steps.append((run_fn, slots, len(metas), recorded))
        self.key_parts.append((step_key, slots, len(metas), recorded))
        self.n_ops += 1
        self.taped = self.taped or recorded
        return refs

    def reads(self, tensors):
        """Whether this open segment reads the storage of any of
        ``tensors`` as an external input."""
        return bool(self._ext_storage) and any(
            _storage_ptr(t) in self._ext_storage for t in tensors)

    def _live(self):
        """Which produced values an NDArray still holds: refs referenced
        beyond this segment's list (and getrefcount's argument)."""
        refs = self.refs
        return [sys.getrefcount(refs[i]) > 2 for i in range(len(refs))]

    def flush(self, origin="flush"):
        """Run the whole segment as one engine push.  Idempotent.

        On failure every unresolved ref is marked dead and every output
        var poisoned (``Var.set_exception``): the async-rethrow contract
        the eager path gives one failing op."""
        if self.flushed:
            return
        self.flushed = True
        eng = self.engine
        st = eng._bulk_state()
        if st.seg is self:
            st.seg = None
        if not self.steps:
            return
        ext = tuple(self.ext)
        stable = tuple(self.stable)
        recorded = self.taped and any(t.requires_grad for t in ext)
        # a graph reads a stable input (a weight, a gradient buffer) in
        # place, so its storage is part of the key: one key, one weight
        key = (tuple(self.key_parts), tuple(
            (tuple(t.shape), t.dtype, t.device, t.requires_grad)
            for t in ext), tuple(t.data_ptr() if s else None
                                 for t, s in zip(ext, stable)))
        run = eng._segment_executable(key, self.steps, self.n_ops,
                                      self.device, recorded, stable)
        live = self._live()
        if hasattr(run, "keep"):
            run.keep = live     # a graph pair copies only held outputs
        _flight.record("engine.flush", origin=origin, ops=self.n_ops)
        try:
            # one push for the op stream; the write vars' versions were
            # bumped at defer time, as eager would have
            vals = eng.push(lambda: run(*ext),
                            op_name="bulk_segment[%d]" % self.n_ops,
                            device=self.device)
        except Exception as e:
            _flight.record("engine.flush_failed", origin=origin,
                           ops=self.n_ops, error=type(e).__name__,
                           writes=len(self.write_vars))
            for r in self.refs:
                r.failed = True
            for v in self.write_vars:
                v.set_exception(e)
            self._release()
            raise
        static = getattr(run, "static", False)
        for i, (r, val) in enumerate(zip(self.refs, vals)):
            if static or getattr(run, "keep", None) is not None:
                # a replay's outputs are the graph's: the next replay
                # overwrites them, so a held value gets its own copy
                # (a pair's are copies already), and no other is kept
                val = (val.clone() if static else val) if live[i] else None
            r.value = val
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for v in self.write_vars:
                v.stream = stream
            eng._devices.add(self.device.index or 0)
        eng.stats.bulk_segments += 1
        kind = origin.split(":", 1)[0]
        fo = eng.stats.flush_origins
        fo[kind] = fo.get(kind, 0) + 1
        self._release()

    def _release(self):
        """Drop the inputs and steps once run: lazy arrays keep their
        refs (and so this segment) alive long after."""
        self.steps = ()
        self.key_parts = ()
        self.ext = ()
        self._ext_ids = None
        self._ext_storage = set()
        self.stable = ()
        self.write_vars = ()
        self.refs = ()


def _storage_ptr(t):
    return t.untyped_storage().data_ptr()


class Engine:
    """Engine façade: ``push`` runs the op's host side now and enqueues its
    device work on torch's current stream."""

    _instance = None

    def __init__(self):
        self.stats = _Stats()
        self._hooks = []        # fn(op_name, t_start, t_end) per push
        self._sync_hooks = []   # fn(origin) per device->host sync
        self._devices = set()   # CUDA device indices work was pushed to
        self.kind = os.environ.get("MXNET_ENGINE_TYPE", "BulkEngine")
        self._bulk_tls = threading.local()   # segments are per thread
        self._bulk_train = env_flag("MXNET_EXEC_BULK_EXEC_TRAIN", True)
        self._bulk_infer = env_flag("MXNET_EXEC_BULK_EXEC_INFERENCE", True)
        self._bulk_max = int(os.environ.get(
            "MXNET_EXEC_BULK_EXEC_MAX_NODE", "64"))
        # an op hook normally turns implicit bulking off (one span per
        # op); MXNET_PROFILE_BULK=1 keeps segments under the hook
        self._profile_bulk = env_flag("MXNET_PROFILE_BULK", False)

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
        poisoned with the error, which is raised.  A push that writes
        flushes this thread's open segment first: the port writes in
        place, and a deferred op must read what was there before."""
        if write_vars and getattr(self._bulk_tls, "seg", None) is not None:
            self.flush_bulk("write:%s" % (op_name or "op"))
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

    # -- bulking ----------------------------------------------------------
    def _bulk_state(self):
        tls = self._bulk_tls
        if not hasattr(tls, "seg"):
            tls.seg = None      # this thread's open BulkSegment
            tls.scopes = []     # explicit bulk(size) scopes
            tls.tiers = tuple(collections.OrderedDict()
                              for _ in _SEG_TIER_BOUNDS)
            tls.shared = {}     # device -> (capture stream, graph pool)
            tls.retired = []    # evicted executables to release
        return tls

    def bulk_size(self):
        """Segment cap for the next deferred op; 0 runs it eagerly.

        An explicit ``bulk(size)`` scope wins; otherwise ``BulkEngine``
        bulks up to ``MXNET_EXEC_BULK_EXEC_MAX_NODE`` when the mode knob
        (TRAIN or INFERENCE) allows and no op hook is attached (unless
        ``MXNET_PROFILE_BULK=1``)."""
        global _autograd
        st = self._bulk_state()
        if st.scopes:
            return max(st.scopes[-1], 0)
        if self.kind != "BulkEngine" or self._bulk_max <= 0:
            return 0
        if self._hooks and not self._profile_bulk:
            return 0
        if _autograd is None:
            from . import autograd as _autograd  # noqa: F811
        knob = self._bulk_train if _autograd.is_training() \
            else self._bulk_infer
        return self._bulk_max if knob else 0

    def current_segment(self, size, device):
        """This thread's open segment on ``device``, made if needed (an
        open segment on another device flushes first)."""
        st = self._bulk_state()
        seg = st.seg
        if seg is not None and not seg.flushed and seg.device != device:
            seg.flush("device")
            seg = None
        if seg is None or seg.flushed:
            seg = st.seg = BulkSegment(self, size, device)
        return seg

    def flush_bulk(self, origin="flush"):
        """Flush this thread's open segment, if any (cheap when none)."""
        st = self._bulk_tls
        seg = getattr(st, "seg", None)
        if seg is not None:
            st.seg = None
            if not seg.flushed:
                seg.flush(origin)

    def flush_if_referencing(self, tensors, origin="write"):
        """Flush this thread's open segment if it reads the storage of
        any of ``tensors``: an in-place write into one must not be seen
        by the ops deferred before it."""
        seg = getattr(self._bulk_tls, "seg", None)
        if seg is not None and not seg.flushed and seg.reads(tensors):
            self.flush_bulk(origin)

    def _segment_executable(self, key, steps, n_ops, device, recorded,
                            stable):
        """The cached executable of one segment key (a tier hit), or a
        new one: on the card a captured call (a graph pair when the
        segment is recorded), on the host the steps run in order."""
        st = self._bulk_state()
        ti = _tier_index(n_ops)
        tier = st.tiers[ti]
        tstats = _seg_tier_stats[ti]
        run = tier.get(key)
        if run is not None:
            tstats["hits"] += 1
            tier.move_to_end(key)
            return run
        tstats["misses"] += 1
        _build_count[0] += 1
        stream = pool = None
        if device.type == "cuda":
            if device not in st.shared:
                st.shared[device] = (torch.cuda.Stream(device),
                                     torch.cuda.graph_pool_handle())
            stream, pool = st.shared[device]
        run = _executable(_segment_fn(steps), device, recorded, stream, pool,
                          "bulk_segment[%d]" % n_ops, stable)
        if hasattr(run, "on_capture"):
            # evicted graphs are released once a newer one holds the
            # pool (a pool whose graphs are all gone takes no capture)
            run.on_capture = self._release_retired
        tier[key] = run
        while len(tier) > _SEG_TIER_BUDGETS[ti]:
            _, old = tier.popitem(last=False)
            tstats["evictions"] += 1
            if hasattr(old, "release"):
                st.retired.append(old)
        return run

    def _release_retired(self):
        st = self._bulk_state()
        retired, st.retired = st.retired, []
        for old in retired:
            old.release()

    def segment_stats(self):
        """Per-tier hits, misses and evictions, and this thread's
        segment graphs (captures, replays, backward replays, busy
        calls)."""
        st = self._bulk_state()
        calls = [r for tier in st.tiers for r in tier.values()
                 if hasattr(r, "captures")]
        return {"tiers": {label: dict(s) for label, s
                          in zip(_SEG_TIER_LABELS, _seg_tier_stats)},
                "graphs": _graph_cache.call_stats(calls)}

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
        self.flush_bulk("waitall")
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
    _metrics.counter("mxnet_engine_bulk_ops_total",
                     help="ops run inside bulk segments"
                     ).set(eng.stats.bulk_ops)
    _metrics.counter("mxnet_engine_bulk_segments_total",
                     help="bulk segments flushed").set(eng.stats.bulk_segments)
    for origin, n in list(eng.stats.sync_origins.items()):
        _metrics.counter("mxnet_engine_sync_total",
                         help="device->host syncs by origin",
                         origin=origin).set(n)


_metrics.register_collector(_telemetry_collector)


def waitall():
    Engine.get().wait_for_all()


def set_bulk_size(size):
    """Set the default segment cap (parity: mxnet.engine.set_bulk_size)
    and return the previous one; 0 flushes what is pending and turns
    implicit bulking off."""
    eng = Engine.get()
    size = int(size)
    if size <= 0:
        eng.flush_bulk("bulk_size_zero")
    prev, eng._bulk_max = eng._bulk_max, size
    return prev


class unbulked:
    """Scope in which every op runs eagerly, as under ``bulk(0)``, but
    entering and leaving flush nothing: the open segment stays open for
    the ops after the scope.  A block's ``hybrid_forward`` runs in it,
    so a call captured into a CUDA graph never flushes (and so never
    captures) ops deferred before the call."""

    def __enter__(self):
        Engine.get()._bulk_state().scopes.append(0)
        return self

    def __exit__(self, *exc):
        Engine.get()._bulk_state().scopes.pop()
        return False


class bulk:
    """Scope bulking consecutive imperative ops (parity:
    mxnet.engine.bulk): up to ``size`` ops a segment, whatever the
    engine's default; ``bulk(0)`` runs every op eagerly.  Entering and
    leaving the scope are segment boundaries."""

    def __init__(self, size):
        self.size = int(size)

    def __enter__(self):
        eng = Engine.get()
        eng.flush_bulk("bulk_scope_enter")
        eng._bulk_state().scopes.append(self.size)
        return self

    def __exit__(self, *exc):
        eng = Engine.get()
        try:
            eng.flush_bulk("bulk_scope_exit")
        finally:
            eng._bulk_state().scopes.pop()
        return False
