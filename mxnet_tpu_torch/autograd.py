"""Imperative autograd: ``record``/``pause``, ``backward``, ``grad`` and
``Function`` on NDArrays.

The port's counterpart of the JAX package's ``autograd.py`` (reference:
``python/mxnet/autograd.py`` and ``src/imperative/imperative.cc``).
The tape is torch's autograd graph:

* ``record()`` turns torch's grad mode on for its scope (and ``pause()``
  turns it off), and is the only place the frontend enables it.  An
  NDArray marked with ``attach_grad`` feeds recorded ops a leaf view of
  its tensor (``requires_grad``, the same storage); every other NDArray
  feeds its tensor.  An op outside ``record()`` is not recorded, also
  when an input carries a graph: ``ops.registry`` runs it under
  ``torch.no_grad()``.
* ``backward`` runs ``torch.autograd.backward`` from the heads and
  writes each marked array's gradient (its leaf view's) by its
  ``grad_req``, a row-sparse one (torch's sparse COO, from
  ``Embedding(sparse_grad=True)``) kept row-sparse; a Gluon block's
  parameters that the heads reach get theirs in ``.grad``, as a tensor
  backward gives them.  ``grad_req``:
  ``write`` copies it over ``.grad``, ``add`` adds it, ``null`` drops
  it.  A head that is not a scalar gets a
  head gradient of ones.  Without ``retain_graph`` the graph is freed,
  and a second backward through it raises ``MXNetError``.
* ``grad(..., create_graph=True)`` returns gradients that are themselves
  recorded, so they can be differentiated again.
* ``Function`` is a ``torch.autograd.Function`` underneath: its
  ``forward`` and ``backward`` run under ``pause()`` and see NDArrays,
  so a backward can launch a kernel of its own (``rtc.CudaKernel``).
  On a CUDA tensor torch runs the backward on its autograd thread.  A
  call flushes the open bulk segment and runs eagerly.
* ops deferred into a bulk segment are recorded too: the segment runs
  them under grad mode at its flush (on the card as a graph pair,
  ``graph_cache.RecordedCall``), and ``backward`` flushes a lazy head
  when it reads it.  Through a graphed segment or hybridized call a
  backward with ``create_graph=True`` raises ``MXNetError``: the
  backward graph cannot be differentiated again.

``train_mode``/``predict_mode`` set the training flag that mode-aware
ops read (``BatchNorm`` takes batch statistics and ``Dropout`` drops
only in train mode); ``record()`` sets it too, unless told otherwise.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

_state = threading.local()
# every NDArray marked with attach_grad/mark_variables, by id (NDArrays
# are unhashable): backward looks here for the leaf views in a graph
_marked = weakref.WeakValueDictionary()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    """Set the recording flag; returns the previous one (parity:
    autograd.set_recording).  Switching recording on turns torch's grad
    mode on, as ``record()`` does, and switching it off again puts back
    the grad mode that was on before (outside ``record()``,
    ``ops.registry`` runs ops under ``no_grad`` whatever the mode)."""
    st = _st()
    prev, rec = st.recording, bool(is_record)
    if rec and not prev:
        st.grad_mode_before = torch.is_grad_enabled()
        torch.set_grad_enabled(True)
    elif prev and not rec and getattr(st, "grad_mode_before", None) \
            is not None:
        torch.set_grad_enabled(st.grad_mode_before)
        st.grad_mode_before = None
    st.recording = rec
    return prev


def set_training(train_mode):
    """Set the training flag; returns the previous one (parity:
    autograd.set_training)."""
    st = _st()
    prev, st.training = st.training, bool(train_mode)
    return prev


class _RecordingStateScope:
    """Sets the recording and training flags for a scope; entering a
    recording (pausing) scope turns torch's grad mode on (off)."""

    def __init__(self, is_record, train_mode):
        self._rec = is_record
        self._train = train_mode
        self._prev = []

    def __enter__(self):
        st = _st()
        self._prev.append((st.recording, st.training,
                           torch.is_grad_enabled()))
        if self._rec is not None:
            st.recording = self._rec
            torch.set_grad_enabled(self._rec)
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training, grad_mode = self._prev.pop()
        torch.set_grad_enabled(grad_mode)


def record(train_mode=True):
    """Scope in which ops on marked arrays are recorded (parity:
    autograd.record)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _heads_and_grads(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    if len(head_grads) != len(heads):
        raise MXNetError("len(head_grads) != len(heads)")
    return heads, [_head_grad(h, g) for h, g in zip(heads, head_grads)]


def _head_grad(head, hg):
    """The head gradient as a tensor in the head's dtype: ones by
    default (also for a head that is not a scalar)."""
    from .ndarray.ndarray import NDArray

    if hg is None:
        return torch.ones_like(head._data)
    t = hg._data if isinstance(hg, NDArray) else torch.as_tensor(hg)
    return t.to(head._data.device, head._data.dtype)


def _differentiate(outputs, grads, inputs, retain_graph, create_graph):
    """``torch.autograd.grad`` with MXNet's error for a freed graph."""
    try:
        return torch.autograd.grad(outputs, inputs, grads,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        if "backward through the graph a second time" in str(e):
            raise MXNetError(
                "graph already freed by a previous backward; pass "
                "retain_graph=True to backward() to reuse it") from e
        raise


def _accumulate(outputs, grads, retain_graph):
    """``torch.autograd.backward``: every leaf the heads reach adds its
    gradient to ``.grad`` (a Gluon block's parameters through the write
    rule of ``gluon.block``), with MXNet's error for a freed graph."""
    try:
        torch.autograd.backward(outputs, grads, retain_graph=retain_graph)
    except RuntimeError as e:
        if "backward through the graph a second time" in str(e):
            raise MXNetError(
                "graph already freed by a previous backward; pass "
                "retain_graph=True to backward() to reuse it") from e
        raise


def _split_heads(heads, grads):
    """Heads with a graph, and marked leaves used as heads themselves."""
    graph, bare = ([], []), []
    for h, g in zip(heads, grads):
        if h._data.grad_fn is not None:
            graph[0].append(h._data)
            graph[1].append(g)
        elif h._marked:
            bare.append((h, g))
        else:
            raise MXNetError("cannot differentiate a head that is not in "
                             "the recorded graph")
    return graph, bare


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run the reverse pass from ``heads`` (parity: MXAutogradBackwardEx).

    Every marked array whose leaf view took part writes its gradient by
    its ``grad_req``; the parameters of the Gluon blocks the heads were
    computed by get theirs in ``.grad`` (by each one's ``grad_req``).
    ``train_mode`` is accepted for parity."""
    heads, grads = _heads_and_grads(heads, head_grads)
    (outs, ograds), bare = _split_heads(heads, grads)
    leaves = [a for a in list(_marked.values()) if a._leaf is not None]
    found = {}
    if outs:
        for a in leaves:
            a._leaf.grad = None
        _accumulate(outs, ograds, retain_graph)
        for a in leaves:
            g, a._leaf.grad = a._leaf.grad, None
            if g is not None:
                found[id(a)] = (a, g)
    with torch.no_grad():
        for h, g in bare:
            prev = found.get(id(h))
            found[id(h)] = (h, g if prev is None else prev[1] + g)
        for a, g in found.values():
            a._write_grad(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, leaving
    ``.grad`` alone (parity: autograd.grad).  With ``create_graph=True``
    the returned gradients are recorded and can be differentiated
    again."""
    from .ndarray.ndarray import NDArray

    single = isinstance(variables, NDArray)
    var_list = [variables] if single else list(variables)
    heads, grads = _heads_and_grads(heads, head_grads)
    (outs, ograds), bare = _split_heads(heads, grads)
    if retain_graph is None:
        retain_graph = create_graph
    inputs = [v._graph_input() for v in var_list]
    res = [None] * len(var_list)
    if outs:
        with torch.enable_grad() if create_graph else torch.no_grad():
            res = list(_differentiate(outs, ograds, inputs, retain_graph,
                                      create_graph))
    for i, v in enumerate(var_list):
        for h, g in bare:
            if h is v:
                res[i] = g if res[i] is None else res[i] + g
        if res[i] is None:
            res[i] = torch.zeros_like(v._data)
    out = [_grad_array(r, v.context) for r, v in zip(res, var_list)]
    return out[0] if single else out


def _grad_array(g, ctx):
    """A gradient tensor as an NDArray, a row-sparse one (torch's sparse
    COO, from ``Embedding(sparse_grad=True)``) as a RowSparseNDArray."""
    from .ndarray.ndarray import NDArray

    if g.is_sparse:
        from .ndarray.sparse import RowSparseNDArray

        return RowSparseNDArray._from_torch(g, ctx)
    return NDArray(g, ctx=ctx)


class _Bridge(torch.autograd.Function):
    """Runs a user ``Function``'s forward and backward on NDArrays inside
    torch's autograd graph."""

    @staticmethod
    def forward(ctx, func, *datas):
        from .ndarray.ndarray import NDArray

        ctx.func = func
        with pause():
            outs = func.forward(*[NDArray(d) for d in datas])
        outs = [outs] if isinstance(outs, NDArray) else list(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray

        with pause():
            igrads = ctx.func.backward(*[NDArray(c) for c in cts])
        if isinstance(igrads, NDArray) or igrads is None:
            igrads = [igrads]
        return (None,) + tuple(
            g._data if isinstance(g, NDArray) else g for g in igrads)


class Function:
    """Custom-gradient block (parity: autograd.Function).

    Subclasses define ``forward(*inputs)`` and ``backward(*output_grads)``
    on NDArrays; both run under ``pause()``.  ``backward`` returns one
    gradient per NDArray input."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):  # pragma: no cover - abstract
        raise NotImplementedError

    def backward(self, *output_grads):  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, *inputs):
        from .engine import Engine
        from .ndarray.ndarray import NDArray

        # never deferred (its forward may launch a kernel of its own)
        Engine.get().flush_bulk("function")
        nd_in = [i for i in inputs if isinstance(i, NDArray)]
        if len(nd_in) != len(inputs):
            raise MXNetError("autograd.Function takes NDArray inputs only")
        if not (is_recording() and any(i._in_graph for i in nd_in)):
            with pause():
                return self.forward(*inputs)
        outs = _Bridge.apply(self, *[i._graph_input() for i in nd_in])
        ctx = nd_in[0].context
        res = [NDArray(o, ctx=ctx) for o in outs]
        return res[0] if len(res) == 1 else res


def mark_variables(variables, gradients, grad_reqs="write"):
    """Parity: autograd.mark_variables — ``gradients[i]`` becomes the
    gradient buffer of ``variables[i]``."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._mark(req, g._data if hasattr(g, "_data") else g)
