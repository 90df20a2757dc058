"""One captured CUDA graph per call signature: the port's counterpart of
the JAX package's executable cache.

The JAX package never runs its compiled paths op by op.
``HybridBlock.hybridize()`` traces the forward into one executable per
input signature (``mxnet_tpu/gluon/block.py`` ``_call_cached``), and the
server runs one AOT-compiled executable per step signature
(``mxnet_tpu/serve/model.py`` ``compile_serving_executables``).  On the
card the counterpart is a CUDA graph per signature: the host enqueues a
step's kernels with one ``cudaGraphLaunch`` instead of one launch each.

:class:`CapturedCall` holds one signature's graph.  Its rule is the
reference's: the first call runs eagerly (here on the capture stream, so
that cuBLAS and the nvcc-built libraries set themselves up outside the
capture), the second captures the function over static input buffers
and replays it, and later calls copy their inputs into those buffers and
replay.  Tensors the graph uses in place (weights, the serve arena) are
named by ``watched``; when one of them has moved since the capture, the
next call captures again.  A capture that fails raises: nothing falls
back to eager running.  On a device other than CUDA every call runs
eagerly.

Kernel wrappers count their launches through :func:`count`.  During a
capture on the calling thread the launches are recorded into the graph
being captured instead (capture launches nothing), and every replay
adds them to the counters.

Captures are serialised across the process by one lock, and each one
runs in ``thread_local`` capture mode on its owner's non-blocking
stream, so a second serve loop in the process may launch and allocate
while another loop captures.

:class:`CallCache` is one owner's calls by key (a hybridized block's,
a serve runner's), with the stream and the memory pool they share.
"""
from __future__ import annotations

import threading
import time
import warnings

import torch

from .base import MXNetError

_tls = threading.local()
_count_lock = threading.Lock()
_capture_lock = threading.Lock()

# bumped whenever a module, parameter or buffer is registered anywhere
# (or a module's tensors are converted): a cached list of a module
# tree's tensors is current while this is unchanged
_tree_generation = 0


def tree_changed(*_):
    """Mark every cached list of a module tree's tensors stale."""
    global _tree_generation
    _tree_generation += 1


def tree_generation():
    """The count :func:`tree_changed` bumps."""
    return _tree_generation


for _hook in (torch.nn.modules.module.register_module_module_registration_hook,
              torch.nn.modules.module.register_module_parameter_registration_hook,
              torch.nn.modules.module.register_module_buffer_registration_hook):
    _hook(tree_changed)


def count(owner, name, n=1):
    """Add ``n`` launches to the counter ``owner.name``, or, while this
    thread captures a graph, to that graph's record (added on each of
    its replays)."""
    if not n:
        return
    rec = getattr(_tls, "recording", None)
    if rec is not None:
        rec[(owner, name)] = rec.get((owner, name), 0) + n
        return
    with _count_lock:
        setattr(owner, name, getattr(owner, name) + n)


class recording:
    """Scope in which :func:`count` records into a dict (``as rec``)
    keyed by ``(owner, name)`` instead of adding to the counters."""

    def __enter__(self):
        self._prev = getattr(_tls, "recording", None)
        _tls.recording = {}
        return _tls.recording

    def __exit__(self, *exc):
        _tls.recording = self._prev


def signature(args, training=False):
    """The cache key of one call: each tensor argument's ``(shape,
    dtype, device)``, any other argument as it is, and the training
    flag (the reference keys by shapes, dtypes and
    ``autograd.is_training()``)."""
    return (tuple((tuple(a.shape), a.dtype, a.device)
                  if isinstance(a, torch.Tensor) else a for a in args),
            bool(training))


def storage_key(tensors):
    """What a capture holds of the tensors it uses in place: each one's
    data pointer, dtype and shape.  A change means the graph would read
    memory that no longer holds the tensor."""
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape)) for t in tensors)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _indexed(device):
    """``device`` with its index (``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _end_quietly(graph, device, pool):
    """End a capture into ``pool`` that ``fn`` broke off; its own error
    is the one raised.  Where CUDA had invalidated the capture (a host
    read, a synchronisation), ``capture_end`` raises before torch leaves
    capture mode: the caching allocator still routes allocations to the
    pool and the CUDA generators still expect a capture, so the next
    random draw outside a graph would fail.  Both are undone here."""
    try:
        graph.capture_end()
        return
    except RuntimeError:
        pass
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except RuntimeError:
        pass            # not open (torch closed it, or it never began)
    else:
        torch._C._cuda_releasePool(device.index, pool)
    # capture_end of an empty capture takes the generators out of
    # capture mode
    blank = torch.cuda.CUDAGraph()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "the CUDA graph is empty"
        blank.capture_begin(capture_error_mode="thread_local")
        blank.capture_end()


def pool_bytes(pool, device=None):
    """Bytes of device memory held by the graph memory pool ``pool``
    (from the caching allocator's snapshot)."""
    want = tuple(pool)
    index = torch.device(device).index if device is not None else None
    return sum(seg["total_size"]
               for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == want
               and (index is None or seg["device"] == index))


class CapturedCall:
    """``fn`` at one call signature, replayed as one CUDA graph.

    ``fn(*args)`` is called with tensor arguments copied into static
    buffers on ``device`` (the caller's tensors may live on the host)
    and any other argument as given.  ``watched()`` returns the tensors
    ``fn`` uses in place.  ``stream`` (a non-blocking
    ``torch.cuda.Stream``) runs the warm-up and the capture; ``pool``
    (``torch.cuda.graph_pool_handle()``) may be shared by graphs of one
    owner that never run at once and whose outputs are read before the
    next of them replays.

    A replay returns the graph's static outputs, which the next replay
    overwrites; ``static`` says whether the last call returned them.
    ``calls``, ``captures``, ``replays``, ``capture_s`` and ``host_s``
    (host seconds of the replayed calls outside ``graph.replay()``)
    count what happened.
    """

    def __init__(self, fn, device, watched=None, stream=None, pool=None,
                 label="call"):
        self.fn = fn
        self.device = _indexed(device)
        self.watched = watched or (lambda: ())
        self.label = label
        self.graphed = self.device.type == "cuda"
        if self.graphed and stream is None:
            stream = torch.cuda.Stream(self.device)
        self.stream = stream
        self.pool = pool
        self.calls = self.captures = self.replays = 0
        self.capture_s = self.host_s = 0.0
        self.static = False
        self.graph = None
        self._static_in = self._out = self._key = None
        self._launches = {}

    def __call__(self, *args):
        self.calls += 1
        self.static = False
        if not self.graphed:
            return self.fn(*args)
        if self.calls == 1:
            return self._warm_up(args)
        t0 = time.perf_counter()
        if self.graph is None or self._key != storage_key(self.watched()):
            self._capture(args)
            t0 = time.perf_counter()
        for buf, a in zip(self._static_in, args):
            if isinstance(a, torch.Tensor):
                buf.copy_(a, non_blocking=True)
        t1 = time.perf_counter()
        self.graph.replay()
        t2 = time.perf_counter()
        for (owner, name), n in self._launches.items():
            count(owner, name, n)
        self.replays += 1
        self.static = True
        self.host_s += (t1 - t0) + (time.perf_counter() - t2)
        return self._out

    def _warm_up(self, args):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = self.fn(*(a.to(self.device)
                            if isinstance(a, torch.Tensor) else a
                            for a in args))
        cur.wait_stream(self.stream)
        for t in _tensors(out):
            if t.device.type == "cuda":
                t.record_stream(cur)
        return out

    def release(self):
        """Drop the graph, its static buffers and outputs, after the
        work queued on the current stream (a replay) has finished, so
        that no replay reads the pool after it is freed.  The owner of a
        pool whose every graph was released takes a new pool handle for
        its next capture."""
        if self.graph is not None:
            torch.cuda.current_stream(self.device).synchronize()
        self.graph = self._static_in = self._out = self._key = None
        self._launches = {}

    def _capture(self, args):
        # the old graph (if a watched tensor moved) is released only
        # after the new capture, so that the pool it shares stays in use
        static = tuple(torch.empty(a.shape, dtype=a.dtype, device=self.device)
                       if isinstance(a, torch.Tensor) else a for a in args)
        cur = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        pool = self.pool if self.pool is not None \
            else torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        with _capture_lock, recording() as rec, \
                torch.cuda.device(self.device):
            self.stream.wait_stream(cur)
            try:
                with torch.cuda.stream(self.stream):
                    try:
                        graph.capture_begin(pool=pool,
                                            capture_error_mode="thread_local")
                        out = self.fn(*static)
                    except BaseException:
                        _end_quietly(graph, self.device, pool)
                        raise
                    graph.capture_end()
            except Exception as e:
                raise MXNetError("CUDA graph capture of %s failed: %s: %s"
                                 % (self.label, type(e).__name__, e)) from e
            cur.wait_stream(self.stream)
        self.release()
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        self.graph, self._static_in, self._out = graph, static, out
        self._launches = rec
        self._key = storage_key(self.watched())


class CallCache:
    """One owner's captured calls (:class:`CapturedCall`) by key.

    The calls on one device share a capture stream and a memory pool:
    an owner runs its calls one at a time on one thread and reads each
    call's outputs before the next one replays.  :meth:`clear` releases
    every graph and takes a new pool for the next capture, since a pool
    whose graphs were all released cannot take one.
    """

    def __init__(self):
        self.calls = {}
        self._shared = {}       # device -> (stream, pool)

    def get(self, key, fn, device, watched, label):
        """The call cached under ``key``, made from the other arguments
        (as :class:`CapturedCall` takes them) on a miss."""
        cc = self.calls.get(key)
        if cc is None:
            device = _indexed(device)
            stream = pool = None
            if device.type == "cuda":
                if device not in self._shared:
                    self._shared[device] = (torch.cuda.Stream(device),
                                            torch.cuda.graph_pool_handle())
                stream, pool = self._shared[device]
            cc = self.calls[key] = CapturedCall(
                fn, device, watched=watched, stream=stream, pool=pool,
                label=label)
        return cc

    def clear(self):
        """Release every graph."""
        for cc in self.calls.values():
            cc.release()
        self.calls = {}
        self._shared = {}

    def stats(self):
        """Graphs held, captures, replays, capture seconds, host seconds
        of the replayed calls outside the replays, and the pools'
        bytes."""
        calls = list(self.calls.values())
        return {"graphs": sum(cc.graph is not None for cc in calls),
                "captures": sum(cc.captures for cc in calls),
                "replays": sum(cc.replays for cc in calls),
                "capture_s": sum(cc.capture_s for cc in calls),
                "host_s": sum(cc.host_s for cc in calls),
                "pool_bytes": sum(pool_bytes(pool, dev) for dev, (_, pool)
                                  in self._shared.items())}
