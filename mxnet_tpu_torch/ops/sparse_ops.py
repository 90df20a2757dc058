"""O7 ``csr_dot`` and O8 ``rsp_lazy_update``: the port-only kernels of the
sparse tier (``csrc/sparse_ops.cu``, built by ``ops/_build.py`` at first
use).

No Pallas kernel stands behind them.  The JAX package keeps sparse
arrays as structured dense pairs and XLA fuses their gathers and
scatters; eagerly in torch each of those is a launch of its own.

- ``csr_dot`` serves ``sparse.dot`` (``mxnet_tpu/ndarray/sparse.py:408``):
  ``A . rhs`` or ``A^T . rhs`` for a CSR matrix ``A`` given as its
  values, int64 ``indptr`` and int64 column indices.  Its plain version
  ``csr_dot_ref`` is the JAX package's formula: ``index_select``, the
  product, ``index_add_``.
- ``rsp_lazy_update`` serves the lazy update of a row-sparse gradient
  (``mxnet_tpu/optimizer/optimizer.py:170``): the listed rows of the
  weight and of its state take one step of SGD (with or without
  momentum), Adam or AdaGrad, and no other row is touched.  Its plain
  version ``rsp_lazy_update_ref`` gathers the rows, runs the
  optimizer's own step on them in plain torch (``Optimizer._step_multi``
  with ``plain``: O2's and O1's plain versions for SGD and Adam) and
  writes them back with ``index_copy_``.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises (float32 only, int64 indices, contiguous
operands).  ``csr_dot.launches`` and ``rsp_lazy_update.launches`` count
kernel launches (``graph_cache.count``), ``csr_dot.transposed_launches``
those of ``csr_dot`` with ``transpose_a``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import graph_cache as _graph_cache
from ..base import MXNetError
from . import _build

_SOURCE = _build.source_path("sparse_ops.cu")
# O8's routes, as the kernel numbers them
ROUTES = {"sgd": 0, "sgd_mom": 1, "adam": 2, "adagrad": 3}


def csr_rows(indptr, m, nnz):
    """The row of each stored value of a CSR matrix with ``m`` rows and
    ``nnz`` values (no host read: the output size is given)."""
    counts = indptr[1:m + 1] - indptr[:m]
    return torch.repeat_interleave(
        torch.arange(m, device=indptr.device), counts, output_size=nnz)


# -- plain versions -----------------------------------------------------------

def csr_dot_ref(data, indptr, indices, rhs, shape, transpose_a=False):
    """What O7 computes: ``A . rhs`` (``A^T . rhs`` with ``transpose_a``)
    for the (m, n) CSR matrix ``A``, as the JAX package forms it: each
    stored value times the ``rhs`` row it meets, summed by ``index_add_``
    into its output row."""
    m, n = shape
    rows = csr_rows(indptr, m, data.shape[0])
    if transpose_a:
        contrib = data[:, None] * rhs.index_select(0, rows)
        out = contrib.new_zeros((n, rhs.shape[1]))
        return out.index_add_(0, indices, contrib)
    contrib = data[:, None] * rhs.index_select(0, indices)
    out = contrib.new_zeros((m, rhs.shape[1]))
    return out.index_add_(0, rows, contrib)


def _state_rows(state, fn):
    """``fn`` applied to each tensor of an optimizer state (None, a tensor
    or a tuple of tensors), keeping its structure."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_state_rows(s, fn) for s in state)
    return fn(state)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def rsp_lazy_update_ref(weight, indices, values, state, step):
    """What O8 computes, and the lazy update of every other optimizer:
    gather the listed rows of ``weight`` and of each state tensor, run
    ``step(weight_rows, values, state_rows)`` (the optimizer's own step,
    in place on the rows), write the rows back.  Indices outside
    ``[0, n)`` are skipped."""
    n = weight.shape[0]
    keep = (indices >= 0) & (indices < n)
    if not bool(keep.all()):
        indices, values = indices[keep], values[keep]
    if not indices.numel():
        return
    with torch.no_grad():
        rows = weight.index_select(0, indices)
        srows = _state_rows(state, lambda s: s.index_select(0, indices))
        step(rows, values.to(weight.dtype), srows)
        weight.index_copy_(0, indices, rows)
        for s, r in zip(_leaves(state), _leaves(srows)):
            s.index_copy_(0, indices, r)


# -- the kernels --------------------------------------------------------------

def library_path(defines=()):
    """Where the built kernel library lives (``build/`` at the repo root,
    named by a hash of the source and flags)."""
    return _build.library_path(_SOURCE, defines)


def build(verbose=False):
    """Compile ``csrc/sparse_ops.cu`` with nvcc (when its library is not
    built yet) and return its path."""
    return _build.build(_SOURCE, verbose=verbose)


def _bind(lib):
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    n_out = ctypes.POINTER(i)
    # data, indptr, cols, rhs, out; m, n, kdim, nnz; transpose_a; stream
    lib.mxtt_csr_dot.argtypes = [p] * 5 + [ll] * 4 + [i, p, n_out]
    lib.mxtt_csr_dot.restype = i
    # route; w, g, idx, s0, s1, lr, t; u, c, n; lr_mult, wd, rescale,
    # clip, mu, b1, b2, 1-b1, 1-b2, eps; stream
    lib.mxtt_rsp_lazy_update.argtypes = [i] + [p] * 7 + [ll] * 3 \
        + [f] * 10 + [p, n_out]
    lib.mxtt_rsp_lazy_update.restype = i
    lib.mxtt_sparse_error_string.argtypes = [i]
    lib.mxtt_sparse_error_string.restype = ctypes.c_char_p


def _load():
    return _build.load(_SOURCE, _bind)


def _launch(lib, owner, entry, *args):
    launched = ctypes.c_int(0)
    err = entry(*args, ctypes.byref(launched))
    _graph_cache.count(owner, "launches", launched.value)
    if err != 0:
        raise MXNetError("%s launch failed: %s (%d)" % (
            owner.__name__, lib.mxtt_sparse_error_string(err).decode(), err))
    return launched.value


def _check(what, t, dtype, dev, ndim=None):
    if t.dtype != dtype or t.device != dev or not t.is_contiguous() \
            or (ndim is not None and t.dim() != ndim):
        raise MXNetError(
            "%s: %s; takes a contiguous %s%s tensor on %s"
            % (what, "%s %s tensor of shape %s on %s"
               % ("contiguous" if t.is_contiguous() else "strided",
                  t.dtype, tuple(t.shape), t.device),
               "%d-d " % ndim if ndim else "", dtype, dev))


def csr_dot(data, indptr, indices, rhs, shape, transpose_a=False):
    """O7: ``A . rhs``, or ``A^T . rhs`` with ``transpose_a``, for the
    (m, n) CSR matrix ``A`` of values ``data`` (nnz,), ``indptr`` (m + 1,)
    and column ``indices`` (nnz,); ``rhs`` is 2-d with n rows (m with
    ``transpose_a``).  CPU tensors run the plain version; CUDA tensors
    (float32 values and rhs, int64 indices) launch the kernel or raise."""
    m, n = int(shape[0]), int(shape[1])
    want = m if transpose_a else n
    if rhs.dim() != 2 or rhs.shape[0] != want:
        raise MXNetError("csr_dot: rhs of shape %s for a %s matrix%s"
                         % (tuple(rhs.shape), (m, n),
                            " transposed" if transpose_a else ""))
    if indptr.shape[0] != m + 1 or indices.shape[0] != data.shape[0]:
        raise MXNetError("csr_dot: indptr of %d entries and %d indices for "
                         "%d rows and %d values" % (
                             indptr.shape[0], indices.shape[0], m,
                             data.shape[0]))
    if data.device.type == "cpu":
        return csr_dot_ref(data, indptr, indices, rhs, (m, n), transpose_a)
    dev = data.device
    _check("csr_dot values", data, torch.float32, dev, 1)
    _check("csr_dot indptr", indptr, torch.int64, dev, 1)
    _check("csr_dot indices", indices, torch.int64, dev, 1)
    _check("csr_dot rhs", rhs, torch.float32, dev, 2)
    kdim = rhs.shape[1]
    # transposed, the library zeroes the output before its kernel
    out = torch.empty((n if transpose_a else m, kdim), dtype=torch.float32,
                      device=dev)
    if out.numel():
        lib = _load()
        with torch.cuda.device(dev):
            launched = _launch(
                lib, csr_dot, lib.mxtt_csr_dot, data.data_ptr(),
                indptr.data_ptr(), indices.data_ptr(), rhs.data_ptr(),
                out.data_ptr(), m, n, kdim, data.shape[0],
                int(bool(transpose_a)),
                torch.cuda.current_stream(dev).cuda_stream)
        if transpose_a:
            _graph_cache.count(csr_dot, "transposed_launches", launched)
    return out


csr_dot.launches = 0
csr_dot.transposed_launches = 0     # of those, with transpose_a


def rsp_lazy_update(weight, indices, values, state, route, step, lr, t=None,
                    lr_mult=1.0, wd=0.0, rescale=1.0, clip=-1.0,
                    momentum=0.0, beta1=0.9, beta2=0.999, eps=1e-8):
    """O8: one lazy update of the rows ``indices`` (unique, int64) of
    ``weight`` (n, C) and of its ``state`` by the gradient rows ``values``
    (U, C), in place (see the module docstring).  ``route`` is one of
    ``ROUTES``; ``step`` the optimizer's step on gathered rows, which the
    plain version runs.  The kernel reads ``lr`` (a 0-d f32 device
    tensor) times ``lr_mult``, ``t`` (a 0-d int32 device tensor, Adam's
    count), ``wd``, ``rescale``, ``clip`` (< 0: none), ``momentum``,
    ``beta1``, ``beta2`` and ``eps``.  CPU tensors run the plain version;
    CUDA tensors (float32 weight, values and states, contiguous) launch
    the kernel or raise."""
    if weight.device.type == "cpu":
        rsp_lazy_update_ref(weight, indices, values, state, step)
        return
    if route not in ROUTES:
        raise MXNetError("rsp_lazy_update: route %r (one of %s)"
                         % (route, sorted(ROUTES)))
    dev = weight.device
    _check("rsp_lazy_update weight", weight, torch.float32, dev, 2)
    _check("rsp_lazy_update indices", indices, torch.int64, dev, 1)
    _check("rsp_lazy_update values", values, torch.float32, dev, 2)
    leaves = _leaves(state)
    need = {"sgd": 0, "sgd_mom": 1, "adam": 2, "adagrad": 1}[route]
    if len(leaves) != need:
        raise MXNetError("rsp_lazy_update: route %s takes %d state tensors, "
                         "got %d" % (route, need, len(leaves)))
    for s in leaves:
        _check("rsp_lazy_update state", s, torch.float32, dev, 2)
        if s.shape != weight.shape:
            raise MXNetError("rsp_lazy_update: a state of shape %s beside a "
                             "weight of %s" % (tuple(s.shape),
                                               tuple(weight.shape)))
    u, c = values.shape
    if indices.shape[0] != u or c != weight.shape[1]:
        raise MXNetError("rsp_lazy_update: %d indices and values of shape %s"
                         " for a weight of %s" % (
                             indices.shape[0], tuple(values.shape),
                             tuple(weight.shape)))
    if not isinstance(lr, torch.Tensor) or lr.dtype != torch.float32 \
            or lr.device != dev or lr.numel() != 1:
        raise MXNetError("rsp_lazy_update: lr must be a one-element f32 "
                         "tensor on %s" % dev)
    if route == "adam" and (not isinstance(t, torch.Tensor)
                            or t.dtype != torch.int32 or t.device != dev
                            or t.numel() != 1):
        raise MXNetError("rsp_lazy_update: Adam's t must be a one-element "
                         "int32 tensor on %s" % dev)
    if not u:
        return
    lib = _load()
    ptr = (lambda x: x.data_ptr() if x is not None else None)
    s0 = leaves[0] if leaves else None
    s1 = leaves[1] if len(leaves) > 1 else None
    with torch.cuda.device(dev):
        _launch(lib, rsp_lazy_update, lib.mxtt_rsp_lazy_update,
                ROUTES[route], weight.data_ptr(), values.data_ptr(),
                indices.data_ptr(), ptr(s0), ptr(s1), lr.data_ptr(),
                ptr(t) if route == "adam" else None, u, c, weight.shape[0],
                float(lr_mult), float(wd), float(rescale), float(clip),
                float(momentum), float(beta1), float(beta2),
                float(1.0 - beta1), float(1.0 - beta2), float(eps),
                torch.cuda.current_stream(dev).cuda_stream)


rsp_lazy_update.launches = 0
