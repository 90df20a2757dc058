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
eagerly.  A call signature (:func:`signature`) has a JSON form
(:func:`signature_to_wire`), which ``compile_cache`` bundles keep: a
fresh process makes scratch inputs of a saved signature
(:func:`scratch_args`) and :meth:`CapturedCall.prepare` runs the
warm-up and the capture on them before the first call, which is then a
replay.

Kernel wrappers count their launches through :func:`count`.  During a
capture the launches are recorded into the graph being captured instead
(capture launches nothing), and every replay adds them to the counters.
That holds for launches from torch's autograd thread too, which runs a
captured backward's kernels on the capturing stream.

:class:`RecordedCall` is the counterpart of the reference's cached
vjp: a call that autograd records runs as a pair of graphs, a forward
graph that keeps what the backward needs in the pair's own memory pool
and a backward graph that reads it, joined into torch's autograd by one
``torch.autograd.Function``.  A pair is busy from its forward replay to
its backward replay (or until the forward's outputs are released); a
call of the same signature in that time runs eagerly, since a replay
would overwrite the saved activations.  No other graph can: none
shares the pair's pool.

Captures are serialised across the process by one lock, and each one
runs in ``thread_local`` capture mode on its owner's non-blocking
stream, so a second serve loop in the process may launch and allocate
while another loop captures.

:class:`CallCache` is one owner's calls by key (a hybridized block's,
a serve runner's), with the stream they share and the memory pool its
captured calls share.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
import warnings
import weakref

import torch

from .base import MXNetError

_tls = threading.local()
_count_lock = threading.Lock()
_capture_lock = threading.Lock()
# (stream handle, record) of the capture under way: captures are
# serialised by _capture_lock, so there is at most one
_capturing = None

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


def refuse_host_read(what, tensor):
    """Raise ``MXNetError`` when ``what`` is about to read ``tensor`` on
    the host (a data-dependent shape or loop) while this thread captures
    a CUDA graph: the read would invalidate the capture, or a replay
    would repeat the first read's answer."""
    if tensor.is_cuda and torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "%s reads the device on the host (its output shape or its "
            "loop depends on the data), which a CUDA graph cannot "
            "capture: call it outside hybridize()/JitTrainStep, or "
            "keep it eager" % what)


def count(owner, name, n=1):
    """Add ``n`` launches to the counter ``owner.name``, or, while this
    thread captures a graph, to that graph's record (added on each of
    its replays)."""
    if not n:
        return
    rec = getattr(_tls, "recording", None)
    if rec is None and _capturing is not None \
            and torch.cuda.current_stream().cuda_stream == _capturing[0]:
        rec = _capturing[1]     # autograd's thread, inside a capture
    if rec is not None:
        rec[(owner, name)] = rec.get((owner, name), 0) + n
        return
    with _count_lock:
        setattr(owner, name, getattr(owner, name) + n)


class recording:
    """Scope in which :func:`count` records into a dict (``as rec``)
    keyed by ``(owner, name)`` instead of adding to the counters: on this
    thread, and on any thread launching on ``stream`` (a capture's)."""

    def __init__(self, stream=None):
        self._stream = stream

    def __enter__(self):
        global _capturing
        self._prev = getattr(_tls, "recording", None), _capturing
        _tls.recording = {}
        if self._stream is not None:
            _capturing = (self._stream.cuda_stream, _tls.recording)
        return _tls.recording

    def __exit__(self, *exc):
        global _capturing
        _tls.recording, _capturing = self._prev


def memory_format_of(t):
    """``"channels_last"`` for a 4-d (``"channels_last_3d"`` for a 5-d)
    tensor laid out channels-last and not contiguous, else
    ``"contiguous"``."""
    if t.dim() in (4, 5) and not t.is_contiguous():
        fmt = torch.channels_last if t.dim() == 4 \
            else torch.channels_last_3d
        if t.is_contiguous(memory_format=fmt):
            return "channels_last" if t.dim() == 4 else "channels_last_3d"
    return "contiguous"


def signature(args, training=False):
    """The cache key of one call: each tensor argument's ``(shape,
    dtype, device, memory format)``, any other argument as it is, and
    the training flag (the reference keys by shapes, dtypes and
    ``autograd.is_training()``)."""
    return (tuple((tuple(a.shape), a.dtype, a.device, memory_format_of(a))
                  if isinstance(a, torch.Tensor) else a for a in args),
            bool(training))


def signature_to_wire(key):
    """``signature(...)``'s key as JSON-ready data (a bundle's entry), or
    None when an argument other than a tensor is not a plain value."""
    args = []
    for a in key[0]:
        if isinstance(a, tuple) and len(a) == 4 \
                and isinstance(a[1], torch.dtype):
            shape, dtype, device, fmt = a
            args.append({"shape": list(shape),
                         "dtype": str(dtype).replace("torch.", ""),
                         "device": str(device), "format": fmt})
        elif a is None or isinstance(a, (bool, int, float, str)):
            args.append({"value": a})
        else:
            return None
    return {"args": args, "training": bool(key[1])}


def signature_from_wire(doc):
    """The key that :func:`signature_to_wire` wrote."""
    return (tuple((tuple(a["shape"]), getattr(torch, a["dtype"]),
                   torch.device(a["device"]), a["format"])
                  if "shape" in a else a["value"] for a in doc["args"]),
            bool(doc["training"]))


def scratch_args(doc):
    """Arguments of the signature ``doc`` (a wire form): zeros of each
    tensor's shape, dtype, device and memory format, and the other
    values as they are."""
    out = []
    for a in doc["args"]:
        if "shape" not in a:
            out.append(a["value"])
            continue
        t = torch.zeros(a["shape"], dtype=getattr(torch, a["dtype"]),
                        device=a["device"])
        if a["format"] != "contiguous":
            t = t.contiguous(memory_format=getattr(torch, a["format"]))
        out.append(t)
    return tuple(out)


def grad_signature(tensors):
    """Which of ``tensors`` require grad: part of a recorded call's key,
    since its backward graph differentiates exactly those."""
    return tuple(t.requires_grad for t in tensors)


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


def _rebuild(template, flat):
    """``template``'s structure with its tensors taken in order from the
    iterator ``flat``."""
    if isinstance(template, torch.Tensor):
        return next(flat)
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(o, flat) for o in template)
    return template


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


def _copy_in(static, args, inplace=None):
    """Copy the tensor arguments into their static buffers (outside
    autograd: a buffer never joins the caller's graph), but for those
    the graph reads in place."""
    with torch.no_grad():
        for i, (buf, a) in enumerate(zip(static, args)):
            if isinstance(a, torch.Tensor) and not (inplace and inplace[i]):
                buf.copy_(a, non_blocking=True)


def _static_args(args, device, inplace=None, grad=False):
    """The capture's arguments: a static buffer for each tensor argument
    (a leaf that requires grad where the argument does, with ``grad``),
    the argument itself where ``inplace`` marks it, any other argument
    as it is."""
    out = []
    for i, a in enumerate(args):
        if not isinstance(a, torch.Tensor) or (inplace and inplace[i]):
            out.append(a)
            continue
        buf = torch.empty(a.shape, dtype=a.dtype, device=device)
        out.append(buf.requires_grad_(a.requires_grad) if grad else buf)
    return tuple(out)


def _held(call, args):
    """The tensors a call's graph reads in place: the arguments its
    ``inplace`` mask marks, and ``watched()``."""
    mask = call.inplace
    own = [a for i, a in enumerate(args) if mask[i]] if mask else []
    return own + list(call.watched())


@contextlib.contextmanager
def _collector_paused():
    """The cyclic garbage collector off for the block.  A collection
    inside a capture can free a CUDA graph that only a reference cycle
    kept (an earlier step's or block's graphs), and torch's
    ``CUDAGraph.reset()`` during a capture invalidates it
    (``cudaErrorStreamCaptureInvalidated``); the garbage is collected
    after the capture instead."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _capture_into(graph, pool, stream, label, fn):
    """Capture ``fn()`` into ``graph`` on ``stream`` (the caller holds
    ``_capture_lock``), with the collector paused; returns ``fn``'s
    result and the launches counted during the capture.  A failed
    capture raises ``MXNetError``."""
    with recording(stream) as rec, _collector_paused():
        try:
            with torch.cuda.stream(stream):
                try:
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    out = fn()
                except BaseException:
                    _end_quietly(graph, stream.device, pool)
                    raise
                graph.capture_end()
        except Exception as e:
            raise MXNetError("CUDA graph capture of %s failed: %s: %s"
                             % (label, type(e).__name__, e)) from e
    return out, dict(rec)


class _Graph:
    """One captured CUDA graph of ``fn()``.  ``out`` is what ``fn``
    returned at the capture: the static outputs, which every replay
    overwrites (``last`` is the same).  A replay adds the launches
    counted during the capture to the counters."""

    def __init__(self, pool, stream, label, fn):
        self.graph = torch.cuda.CUDAGraph()
        self.out, self._launches = _capture_into(self.graph, pool, stream,
                                                 label, fn)
        self.last = self.out

    def replay(self):
        self.graph.replay()
        for (owner, name), n in self._launches.items():
            count(owner, name, n)


class _HostGraph:
    """The card-free double of :class:`_Graph`, which a graph call on a
    host device captures (the host tests' set-up of a graph pair): the
    capture runs ``fn`` once, and a replay runs it again and copies what
    it returns into the first run's tensors, the double's static
    outputs.  ``last`` is the newest run's result, whose autograd graph
    a backward double differentiates.  A capture on the card runs no
    kernel, so the capture's run puts back what it wrote in place of
    the tensors the call reads in place (``held``: a ``BatchNorm``'s
    running statistics), as they were."""

    def __init__(self, pool, stream, label, fn, held=()):
        self.fn = fn
        before = [(t, t._version, t.detach().clone()) for t in held]
        self.out = self.last = fn()
        with torch.no_grad():
            for t, version, value in before:
                if t._version != version:
                    t.copy_(value)

    def replay(self):
        self.last = self.fn()
        with torch.no_grad():
            for buf, t in zip(_tensors(self.out), _tensors(self.last)):
                buf.copy_(t)


class _GraphCall:
    """What :class:`CapturedCall` and :class:`RecordedCall` share: the
    function and the tensors its graphs read in place, the owner's
    stream and pool, the counters, the eager first call and the capture.

    ``calls``, ``captures``, ``replays``, ``backward_replays``,
    ``busy_calls``, ``capture_s`` and ``host_s`` (host seconds of the
    replayed calls outside the replays) count what happened; ``graphs``
    are the graphs held, captured into ``held_pool``.
    """

    def __init__(self, fn, device, watched=None, stream=None, pool=None,
                 label="call", inplace=None):
        self.fn = fn
        self.device = _indexed(device)
        self.watched = watched or (lambda: ())
        self.inplace = inplace
        self.label = label
        self.graphed = self.device.type == "cuda"
        if self.graphed and stream is None:
            stream = torch.cuda.Stream(self.device)
        self.stream = stream
        self.pool = pool
        self.calls = self.captures = self.replays = 0
        self.backward_replays = self.busy_calls = 0
        self.capture_s = self.host_s = 0.0
        self.on_capture = None      # called after each capture
        self.graphs = ()
        self.held_pool = None
        self._key = None

    def _stale(self, held):
        """Whether the call must capture: nothing is captured, or a
        tensor its graphs read in place (``held``) has moved."""
        return not self.graphs or self._key != storage_key(held)

    @contextlib.contextmanager
    def _on_stream(self):
        """Run the body on the owner's stream, which waits for the
        caller's stream before and is waited for after (off the card,
        as it is)."""
        if not self.graphed:
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield
        cur.wait_stream(self.stream)

    def _warm_up(self, args):
        """The first call: ``fn`` eagerly on the owner's stream, so that
        cuBLAS and the nvcc-built libraries set themselves up outside
        any capture."""
        with self._on_stream():
            out = self.fn(*(a.to(self.device)
                            if isinstance(a, torch.Tensor) else a
                            for a in args))
        for t in _tensors(out):
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(self.device))
        return out

    def _graph(self, pool, label, fn, held):
        """``fn()`` captured into ``pool``: a :class:`_Graph` on the
        card, its :class:`_HostGraph` double elsewhere (``held``: what
        the call reads in place)."""
        if self.graphed:
            return _Graph(pool, self.stream, label, fn)
        return _HostGraph(pool, self.stream, label, fn, held)

    def _capture(self, args, held):
        """Capture the graphs for ``args`` (``_build``) under the
        process's capture lock on the owner's stream, into the owner's
        pool, or into a new one where the call shares none.  The graphs
        held before go only after, so that a pool they share stays in
        use, and after their last replay has run."""
        pool = self.pool
        if pool is None and self.graphed:
            pool = torch.cuda.graph_pool_handle()
        old = self.graphs
        t0 = time.perf_counter()
        with _capture_lock, self._on_stream():
            self._build(args, pool, held)
        if old and self.graphed:
            torch.cuda.current_stream(self.device).synchronize()
        del old
        self.held_pool = pool
        self._key = storage_key(held)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        if self.on_capture is not None:
            self.on_capture()

    def release(self):
        """Drop the graphs, their buffers and outputs, after the work
        queued on the current stream (a replay) has finished, so that no
        replay reads the pool after it is freed.  The owner of a pool
        whose every graph was released takes a new pool handle for its
        next capture."""
        if self.graphs and self.graphed:
            torch.cuda.current_stream(self.device).synchronize()
        self.graphs = ()
        self.held_pool = None
        self._drop()


class CapturedCall(_GraphCall):
    """``fn`` at one call signature, replayed as one CUDA graph.

    ``fn(*args)`` is called with tensor arguments copied into static
    buffers on ``device`` (the caller's tensors may live on the host)
    and any other argument as given, but for the tensor arguments that
    ``inplace`` (a mask) marks: the graph reads those in place, as it
    reads the tensors ``watched()`` returns, and a change of their
    storage captures it again.  ``stream`` (a non-blocking
    ``torch.cuda.Stream``) runs the warm-up and the capture; ``pool``
    (``torch.cuda.graph_pool_handle()``) may be shared by graphs of one
    owner that never run at once and whose outputs are read before the
    next of them replays.

    A replay returns the graph's static outputs, which the next replay
    overwrites; ``static`` says whether the last call returned them.
    ``prepare`` captures ahead of the first call.  Off the card every
    call runs ``fn`` eagerly.
    """

    def __init__(self, fn, device, watched=None, stream=None, pool=None,
                 label="call", inplace=None):
        super().__init__(fn, device, watched=watched, stream=stream,
                         pool=pool, label=label, inplace=inplace)
        self.static = False
        self._static_in = None

    def __call__(self, *args):
        self.calls += 1
        self.static = False
        if not self.graphed:
            return self.fn(*args)
        if self.calls == 1 and not self.graphs:
            return self._warm_up(args)
        t0 = time.perf_counter()
        held = _held(self, args)
        if self._stale(held):
            self._capture(args, held)
            t0 = time.perf_counter()
        _copy_in(self._static_in, args, self.inplace)
        (graph,) = self.graphs
        t1 = time.perf_counter()
        graph.replay()
        self.replays += 1
        self.static = True
        self.host_s += t1 - t0
        return graph.out

    def prepare(self, args, restore=()):
        """Warm up and capture ahead of the first call (a saved
        signature, ``args`` standing in for its inputs), so that the
        first call is a replay.  What the warm-up writes of ``restore``
        (weights, optimizer state, running statistics) is put back after
        it, in place; the capture writes nothing.  Off the card nothing
        is captured: returns False."""
        if not self.graphed or self.graphs:
            return False
        saved = [(t, t.detach().clone()) for t in restore]
        self._warm_up(args)
        with torch.no_grad():
            for t, value in saved:
                t.copy_(value)
        del saved       # the copies' memory, free before the capture
        with _capture_lock:
            # the capture's pool needs the memory the warm-up cached
            torch.cuda.empty_cache()
        self._capture(args, _held(self, args))
        return True

    def _build(self, args, pool, held):
        static = _static_args(args, self.device, self.inplace)
        self.graphs = (self._graph(pool, self.label,
                                   lambda: self.fn(*static), held),)
        self._static_in = static

    def _drop(self):
        self._static_in = None


class _Pair(torch.autograd.Function):
    """A :class:`RecordedCall`'s forward and backward replays inside
    torch's autograd.  ``tensors`` are the call's tensor arguments and
    then the parameters it reads in place; the outputs are copies of the
    forward graph's static outputs."""

    @staticmethod
    def forward(ctx, call, n_args, *tensors):
        outs = call._forward(tensors[:n_args])
        ctx.call = call
        ctx.generation, ctx.hold = call._hold()
        keep = call.keep or (True,) * len(outs)
        # an output nobody holds is handed over as a view of the static
        # buffer (never read), the others as copies
        res = tuple(o.clone() if k else o.detach() for o, k in zip(outs, keep))
        ctx.mark_non_differentiable(
            *[r for r, d in zip(res, call._diff) if not d])
        return res

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():
            raise MXNetError(
                "a backward with create_graph=True reached the graphed "
                "call %s: its backward graph cannot be differentiated "
                "again (a deviation of the port: the JAX package "
                "re-linearises); call it under hybridize(False) or "
                "engine.bulk(0)" % ctx.call.label)
        got = ctx.call._backward(ctx.generation, ctx.hold, grads)
        return (None, None) + tuple(got)


class RecordedCall(_GraphCall):
    """``fn`` at one recorded call signature, as a forward graph and a
    backward graph (the reference's cached jitted vjp).

    ``fn(*args)`` is called with tensor arguments copied into static
    buffers (those requiring grad as leaves that do) and reads the
    tensors ``params()`` returns in place; the backward graph gives the
    gradients of every argument and parameter that requires grad, so
    those flags are part of the caller's key.  The rules are
    :class:`CapturedCall`'s: the first call runs eagerly on the owner's
    stream, the second captures both graphs and replays, later calls
    replay, and a watched tensor that moved is captured again.

    The pair captures into a memory pool of its own, never the owner's:
    the activations its forward leaves for its backward must survive any
    other graph of the owner that replays in between (another key's
    pair, an unrecorded call).  Between a forward replay and its
    backward replay the pair itself is busy: a call then runs ``fn``
    eagerly (``busy_calls`` counts them), because a replay would
    overwrite the activations the pending backward reads.  The
    backward's gradients are copies, since the next backward replay
    overwrites its static outputs; so are the outputs, but for those a
    caller marks as unheld in ``keep`` (a bulk segment's dead values).
    Arguments that ``inplace`` marks are read in place, as the
    parameters are: their storage is part of the capture's check, and
    none of them may change in place between a forward and its
    backward (that raises, where eager autograd raises for saved
    tensors), but those the forward writes itself (running statistics).
    Off the card the graphs are their host doubles.
    """

    def __init__(self, fn, device, params=None, watched=None, stream=None,
                 label="call", inplace=None):
        super().__init__(fn, device, watched=watched, stream=stream,
                         label=label, inplace=inplace)
        self.params = params or (lambda: ())
        self.keep = None    # which outputs to copy (None: all)
        self.busy = False
        self._static_in = self._tensor_mask = self._diff = None
        self._gout = self._targets = None
        self._reads = ()
        self._written = set()
        self._generation = 0
        self._holds = itertools.count(1)
        self._holder = None

    # -- the call --------------------------------------------------------
    def __call__(self, *args):
        self.calls += 1
        if self.busy:
            self.busy_calls += 1
            return self.fn(*args)
        if self.calls == 1:
            return self._warm_up(args)
        held = _held(self, args)
        if self._stale(held):
            self._capture(args, held)
        params = tuple(self.params())
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        self._reads = held
        outs = _Pair.apply(self, len(tensors), *tensors, *params)
        return _rebuild(self.graphs[0].out, iter(outs))

    def _hold(self):
        """Mark the pair busy for one pending backward; the hold ends at
        that backward or when the forward's autograd node is freed.
        What the graphs read in place must not change before the
        backward reads it (eager autograd's saved-tensor check): their
        versions are taken after the forward.  The tensors the forward
        writes in place itself (a ``BatchNorm``'s running statistics,
        found at the capture: a replay bumps no version, the host
        double's run does) are left out: the backward reads none of
        them, and another call of the net may write them again before
        this backward (a GAN's discriminator on real, then fake
        images, in one ``record()``)."""
        hold = next(self._holds)
        self.busy, self._holder = True, hold
        token = _Token()
        weakref.finalize(token, self._free, hold)
        reads = [t for t in self._reads if id(t) not in self._written]
        versions = (reads, [t._version for t in reads])
        return self._generation, (hold, token, versions)

    def _free(self, hold):
        if self._holder == hold:
            self.busy, self._holder = False, None

    def _forward(self, args):
        t0 = time.perf_counter()
        _copy_in([b for b in self._static_in if isinstance(b, torch.Tensor)],
                 args, self._tensor_mask)
        self._generation += 1
        fwd = self.graphs[0]
        t1 = time.perf_counter()
        fwd.replay()
        self.replays += 1
        self.host_s += t1 - t0
        return _tensors(fwd.out)

    def _backward(self, generation, hold, grads):
        if generation != self._generation or not self.graphs:
            raise MXNetError(
                "the graphed call %s was replayed again (or released) "
                "before the backward of an earlier replay (a retained graph "
                "used twice): its saved activations are gone" % self.label)
        held, versions = hold[2]
        if [t._version for t in held] != versions:
            raise MXNetError(
                "a tensor the graphed call %s reads in place was modified "
                "in place between its forward and its backward" % self.label)
        with torch.no_grad():
            for buf, g in zip(self._gout, grads):
                if buf is not None:
                    buf.copy_(g)
        bwd = self.graphs[1]
        bwd.replay()
        self.backward_replays += 1
        self._free(hold[0])
        out = iter(g.clone() if g is not None else None for g in bwd.out)
        return [next(out) if need else None for need in self._targets]

    # -- capture ---------------------------------------------------------
    def _build(self, args, pool, held):
        static = _static_args(args, self.device, self.inplace, grad=True)
        mask = self.inplace or (False,) * len(args)
        tmask = tuple(m for a, m in zip(args, mask)
                      if isinstance(a, torch.Tensor))
        # the arguments go in first: a host double runs fn on them
        _copy_in([b for b in static if isinstance(b, torch.Tensor)],
                 [a for a in args if isinstance(a, torch.Tensor)], tmask)
        params = tuple(self.params())
        # which tensor arguments, then parameters, get a gradient back
        targets = tuple(a.requires_grad for a in args
                        if isinstance(a, torch.Tensor)) \
            + (True,) * len(params)
        # the pool holds activations and gradients: give it the memory
        # the eager first call left cached (no other capture runs while
        # the lock is held)
        torch.cuda.empty_cache()

        def forward():
            with torch.enable_grad():
                return self.fn(*static)

        before = [t._version for t in held]
        fwd = self._graph(pool, self.label, forward, held)
        # what the forward writes in place itself (a BatchNorm's running
        # statistics), which its backward never reads
        self._written = {id(t) for t, v in zip(held, before)
                         if t._version != v}
        outs = _tensors(fwd.out)
        diff = tuple(o.requires_grad for o in outs)
        gout = [torch.zeros_like(o) if d else None
                for o, d in zip(outs, diff)]
        inputs = [t for t in static
                  if isinstance(t, torch.Tensor) and t.requires_grad]
        inputs += list(params)

        def backward():
            # the gradients of the forward's newest run (on the card,
            # the captured one)
            heads = [o for o, d in zip(_tensors(fwd.last), diff) if d]
            if not heads:
                return [None] * len(inputs)
            return torch.autograd.grad(
                heads, inputs, [g for g in gout if g is not None],
                retain_graph=True, allow_unused=True)

        bwd = self._graph(pool, self.label + " backward", backward, held)
        self.graphs = (fwd, bwd)
        self._static_in, self._tensor_mask = static, tmask
        self._diff, self._gout, self._targets = diff, gout, targets

    def _drop(self):
        self._static_in = self._gout = None
        self.busy, self._holder = False, None


class _Token:
    """What a pending backward holds of its pair (a weakref target)."""
    __slots__ = ("__weakref__",)


class CallCache:
    """One owner's graph calls by key: :class:`CapturedCall` and, for
    recorded calls, :class:`RecordedCall`.

    The captured calls on one device share a capture stream and a
    memory pool: an owner runs its calls one at a time on one thread and
    reads each call's outputs before the next one replays.  A recorded
    call shares the stream but captures into a pool of its own.
    :meth:`clear` releases every graph and takes a new pool for the next
    capture, since a pool whose graphs were all released cannot take
    one.
    """

    def __init__(self):
        self.calls = {}
        self._shared = {}       # device -> (stream, pool)

    def pairs_on(self, device):
        """Whether a recorded call on ``device`` runs as a graph pair:
        on the card; elsewhere it runs eagerly."""
        return torch.device(device).type == "cuda"

    def get(self, key, fn, device, watched, label, params=None):
        """The call cached under ``key``, made from the other arguments
        on a miss: a :class:`CapturedCall`, or with ``params`` (the
        tensors a recorded call differentiates in place) a
        :class:`RecordedCall`."""
        cc = self.calls.get(key)
        if cc is None:
            device = _indexed(device)
            stream = pool = None
            if device.type == "cuda":
                if device not in self._shared:
                    self._shared[device] = (torch.cuda.Stream(device),
                                            torch.cuda.graph_pool_handle())
                stream, pool = self._shared[device]
            if params is None:
                cc = CapturedCall(fn, device, watched=watched,
                                  stream=stream, pool=pool, label=label)
            else:
                cc = RecordedCall(fn, device, params=params,
                                  watched=watched, stream=stream,
                                  label=label)
            self.calls[key] = cc
        return cc

    def clear(self):
        """Release every graph."""
        for cc in self.calls.values():
            cc.release()
        self.calls = {}
        self._shared = {}

    def stats(self):
        """Graphs held, captures, replays (backward replays apart),
        busy calls run eagerly, capture seconds, host seconds of the
        replayed calls outside the replays, and the bytes of the pools
        the graphs held were captured into."""
        pools = {(cc.device, tuple(cc.held_pool))
                 for cc in self.calls.values() if cc.held_pool is not None}
        return dict(call_stats(self.calls.values()),
                    pool_bytes=sum(pool_bytes(p, d) for d, p in pools))


def call_stats(calls):
    """What :meth:`CallCache.stats` sums over ``calls`` (captured and
    recorded calls), the pools aside."""
    calls = list(calls)
    out = {"graphs": sum(bool(cc.graphs) for cc in calls)}
    for name in ("captures", "replays", "backward_replays", "busy_calls",
                 "capture_s", "host_s"):
        out[name] = sum(getattr(cc, name) for cc in calls)
    return out
