"""Sparse NDArrays: ``RowSparseNDArray`` and ``CSRNDArray`` (the port's
counterpart of ``mxnet_tpu/ndarray/sparse.py``; reference:
``include/mxnet/ndarray.h:61-65`` and ``python/mxnet/ndarray/sparse.py``).

As in the JAX package, each format is a structured dense pair (or
triple) of arrays, here torch tensors on the array's device: on the
card by default, on the host under ``with mx.cpu():``.

* ``RowSparseNDArray`` — ``indices`` (K,) and ``values`` (K, ...): the
  rows of a gradient that sparse ``Embedding`` touched.  ``compact()``
  gives the canonical layout (unique sorted indices, duplicate rows
  summed) with ``torch.unique`` and a segment sum; on the card it reads
  the row count back to the host, as the JAX package's ``np.unique``
  does.
* ``CSRNDArray`` — ``indptr`` (M + 1,), ``indices`` and ``data_arr``
  for a 2-d matrix.  ``dot`` with a dense right operand runs O7
  (``ops/sparse_ops.py``: the CUDA C++ kernel on the card, its plain
  version on the host) without densifying.

Indices are int64 (the port's 64-bit rule; the JAX package narrows them
to int32).  The CSR conversions and the csr add, multiply and intersect
run on the host in numpy, as the JAX package's do (IO-scale work);
everything else runs on the arrays' device.  Any other operation
densifies with ``tostype("default")``.
"""
from __future__ import annotations

import numbers

import numpy as _np
import torch

from ..base import MXNetError
from ..context import as_context, current_context
from ..ops import sparse_ops as _sops
from ..ops.tensor import to_torch_dtype
from .ndarray import NDArray


def _nd(x, ctx, dtype=None):
    """``x`` as an NDArray on ``ctx``: an NDArray or tensor keeps its
    values (moved if need be), anything else is read as numpy."""
    if isinstance(x, NDArray):
        t = x._data
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        return NDArray(x, ctx=ctx, dtype=dtype)
    if dtype is not None:
        t = t.to(dtype)
    dev = ctx.torch_device
    return NDArray._wrap(t if t.device == dev else t.to(dev), ctx)


def _index(x, ctx):
    """Indices as an int64 NDArray on ``ctx``."""
    return _nd(x, ctx, dtype=torch.int64 if isinstance(
        x, (NDArray, torch.Tensor)) else "int64")


def _ctx_of(ctx, data):
    if ctx is not None:
        return as_context(ctx)
    if isinstance(data, NDArray):
        return data.context
    return current_context()


class BaseSparseNDArray:
    @property
    def _in_graph(self):
        return False

    @property
    def shape(self):
        return self._shape

    @property
    def context(self):
        return self._ctx

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def __repr__(self):
        return "<%s %s @%s>" % (type(self).__name__,
                                "x".join(map(str, self._shape)), self._ctx)


class RowSparseNDArray(BaseSparseNDArray):
    """Rows ``indices`` of a ``shape`` array hold ``values``; every other
    row is zero (parity: ndarray.sparse.RowSparseNDArray)."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None, canonical=False):
        ctx = _ctx_of(ctx, data)
        self.values = _nd(data, ctx)
        self.indices = _index(indices, ctx)
        self._shape = tuple(shape)
        self._ctx = ctx
        # canonical = indices known unique and sorted: compact() is free
        self._canonical = canonical

    @classmethod
    def from_dense(cls, arr):
        """Compress a dense NDArray by dropping its all-zero rows."""
        return row_sparse_array(arr)

    @classmethod
    def _from_torch(cls, g, ctx):
        """The row-sparse array of a torch sparse COO gradient (rows along
        its first dimension), compacted."""
        g = g.detach()
        rsp = cls(NDArray._wrap(g._values(), ctx),
                  NDArray._wrap(g._indices()[0], ctx), tuple(g.shape),
                  ctx=ctx, canonical=g.is_coalesced())
        return rsp.compact()

    def compact(self):
        """An equivalent RowSparseNDArray with unique sorted indices
        (duplicate rows summed): the canonical layout."""
        if self._canonical:
            return self
        vals = self.values._data
        uniq, inv = torch.unique(self.indices._data, sorted=True,
                                 return_inverse=True)
        summed = vals.new_zeros((uniq.shape[0],) + tuple(vals.shape[1:]))
        summed.index_add_(0, inv, vals)
        return RowSparseNDArray(NDArray._wrap(summed, self._ctx),
                                NDArray._wrap(uniq, self._ctx), self._shape,
                                ctx=self._ctx, canonical=True)

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            idx = torch.cat([self.indices._data, other.indices._data])
            vals = torch.cat([self.values._data,
                              other.values._data.to(self.values._data.dtype)])
            return RowSparseNDArray(NDArray._wrap(vals, self._ctx),
                                    NDArray._wrap(idx, self._ctx),
                                    self._shape, ctx=self._ctx).compact()
        return self.tostype("default") + other

    def scatter_add_into(self, dense_raw):
        """``dense_raw`` with the stored rows added at their indices (a
        new tensor)."""
        return dense_raw.index_add(0, self.indices._data,
                                   self.values._data.to(dense_raw.dtype))

    @property
    def dtype(self):
        return self.values.dtype

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            vals = self.values._data
            dense = vals.new_zeros(self._shape)
            dense.index_copy_(0, self.indices._data, vals)
            return NDArray._wrap(dense, self._ctx)
        raise MXNetError("cannot convert row_sparse to %s" % stype)

    def copyto(self, other):
        return self.tostype("default").copyto(other)


class CSRNDArray(BaseSparseNDArray):
    """A 2-d matrix in compressed sparse row form: row ``r``'s values are
    ``data_arr[indptr[r]:indptr[r + 1]]`` at columns ``indices[...]`` of
    the same slice (parity: ndarray.sparse.CSRNDArray)."""

    stype = "csr"

    @classmethod
    def from_dense(cls, arr):
        return csr_matrix(arr)

    def __init__(self, data, indptr, indices, shape, ctx=None):
        ctx = _ctx_of(ctx, data)
        self.data_arr = _nd(data, ctx)
        self.indptr = _index(indptr, ctx)
        self.indices = _index(indices, ctx)
        self._shape = tuple(shape)
        self._ctx = ctx

    @property
    def dtype(self):
        return self.data_arr.dtype

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            m, n = self._shape
            vals = self.data_arr._data
            rows = _sops.csr_rows(self.indptr._data, m, vals.shape[0])
            dense = vals.new_zeros((m, n))
            dense[rows, self.indices._data] = vals
            return NDArray._wrap(dense, self._ctx)
        raise MXNetError("cannot convert csr to %s" % stype)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` or from a dense array
    (its nonzero rows)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if not isinstance(data, (NDArray, torch.Tensor)):
            data = _np.asarray(data, dtype=dtype or "float32")
        return RowSparseNDArray(data, indices, shape, ctx=ctx)
    dense = _np.asarray(arg1.asnumpy() if isinstance(arg1, NDArray) else arg1,
                        dtype=dtype or "float32")
    nz = _np.where(_np.any(dense.reshape(dense.shape[0], -1) != 0, axis=1))[0]
    return RowSparseNDArray(dense[nz], nz.astype(_np.int64), dense.shape,
                            ctx=_ctx_of(ctx, arg1), canonical=True)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or from a dense 2-d
    array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if not isinstance(data, (NDArray, torch.Tensor)):
            data = _np.asarray(data, dtype=dtype or "float32")
        return CSRNDArray(data, indptr, indices, shape, ctx=ctx)
    dense = _np.asarray(arg1.asnumpy() if isinstance(arg1, NDArray) else arg1,
                        dtype=dtype or "float32")
    m, n = dense.shape
    rows, cols = _np.nonzero(dense)        # row-major: each row's sorted
    indptr = _np.zeros(m + 1, _np.int64)
    _np.cumsum(_np.bincount(rows, minlength=m), out=indptr[1:])
    return CSRNDArray(dense[rows, cols], indptr, cols.astype(_np.int64),
                      (m, n), ctx=_ctx_of(ctx, arg1))


def dense_to(arr, stype):
    if stype == "row_sparse":
        return row_sparse_array(arr)
    if stype == "csr":
        return csr_matrix(arr)
    raise MXNetError("unknown stype %s" % stype)


def zeros(stype, shape, ctx=None, dtype=None):
    """An empty sparse array (or dense zeros for ``"default"``)."""
    dt = dtype or "float32"
    if stype not in ("row_sparse", "csr"):
        from .ndarray import zeros as dzeros

        return dzeros(shape, ctx=ctx, dtype=dt)
    ctx = _ctx_of(ctx, None)
    dev, tdt = ctx.torch_device, to_torch_dtype(dt)
    none = torch.zeros((0,), dtype=torch.int64, device=dev)
    if stype == "row_sparse":
        vals = torch.zeros((0,) + tuple(shape[1:]), dtype=tdt, device=dev)
        return RowSparseNDArray(vals, none, shape, ctx=ctx, canonical=True)
    return CSRNDArray(torch.zeros((0,), dtype=tdt, device=dev),
                      torch.zeros((shape[0] + 1,), dtype=torch.int64,
                                  device=dev), none, shape, ctx=ctx)


def retain(data, indices):
    """Keep only the given rows of a RowSparseNDArray (parity:
    sparse_retain)."""
    keep = indices._data if isinstance(indices, NDArray) \
        else torch.as_tensor(_np.asarray(indices))
    cur = data.indices._data
    mask = torch.isin(cur, keep.to(cur.device, torch.int64))
    return RowSparseNDArray(NDArray._wrap(data.values._data[mask],
                                          data.context),
                            NDArray._wrap(cur[mask], data.context),
                            data.shape, ctx=data.context,
                            canonical=data._canonical)


def cast_storage(arr, stype):
    """Convert between storage types (parity:
    ``src/operator/tensor/cast_storage.cc``): ``default`` to and from
    ``row_sparse`` and ``csr``; sparse to sparse goes through dense."""
    cur = getattr(arr, "stype", "default")
    if cur == stype:
        return arr
    if cur != "default":
        arr = arr.tostype("default")
        if stype == "default":
            return arr
    if stype == "row_sparse":
        return row_sparse_array(arr)
    if stype == "csr":
        if len(arr.shape) != 2:
            raise MXNetError("cast_storage to csr needs a 2-D array")
        return csr_matrix(arr)
    raise MXNetError("cast_storage: unknown stype %r" % (stype,))


def _csr_to_coo_rows(csr):
    indptr = csr.indptr.asnumpy().astype(_np.int64)
    return _np.repeat(_np.arange(csr.shape[0]), _np.diff(indptr))


def _coo_to_csr(rows, cols, vals, shape, ctx):
    """Canonicalize COO (sorted, duplicates summed, zeros dropped) into a
    CSRNDArray, on the host."""
    order = _np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], _np.asarray(vals)[order]
    if len(rows):
        key = rows * shape[1] + cols
        uniq, inv = _np.unique(key, return_inverse=True)
        summed = _np.zeros(len(uniq), vals.dtype)
        _np.add.at(summed, inv, vals)
        rows, cols, vals = uniq // shape[1], uniq % shape[1], summed
        nz = summed != 0
        rows, cols, vals = rows[nz], cols[nz], vals[nz]
    indptr = _np.zeros(shape[0] + 1, _np.int64)
    _np.add.at(indptr, rows + 1, 1)
    _np.cumsum(indptr, out=indptr)
    return CSRNDArray(vals, indptr, cols, shape, ctx=ctx)


def _dense(x):
    return x.tostype("default") if isinstance(x, BaseSparseNDArray) else x


def add(lhs, rhs):
    """Sparse-aware elementwise add (parity: ``elemwise_add``'s sparse
    dispatch): csr + csr stays csr (merged on the host), rsp + rsp stays
    row-sparse (compacted), any other pairing is dense."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        if lhs.shape != rhs.shape:
            raise MXNetError("sparse add: shape mismatch")
        rows = _np.concatenate([_csr_to_coo_rows(lhs),
                                _csr_to_coo_rows(rhs)])
        cols = _np.concatenate([lhs.indices.asnumpy(),
                                rhs.indices.asnumpy()]).astype(_np.int64)
        vals = _np.concatenate([lhs.data_arr.asnumpy(),
                                rhs.data_arr.asnumpy()])
        return _coo_to_csr(rows, cols, vals, lhs.shape, lhs.context)
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        return lhs + rhs
    return _dense(lhs) + _dense(rhs)


def multiply(lhs, rhs):
    """Sparse-aware elementwise multiply: csr * csr and rsp * rsp
    intersect the patterns, sparse * scalar scales the stored values,
    sparse * dense keeps the sparse operand's pattern; the product
    commutes (the sparse operand drives)."""
    if isinstance(lhs, numbers.Number):
        lhs, rhs = rhs, lhs
    elif not isinstance(lhs, BaseSparseNDArray) and \
            isinstance(rhs, BaseSparseNDArray):
        lhs, rhs = rhs, lhs
    if isinstance(rhs, numbers.Number):
        if isinstance(lhs, RowSparseNDArray):
            return RowSparseNDArray(
                NDArray._wrap(lhs.values._data * float(rhs), lhs.context),
                lhs.indices, lhs.shape, ctx=lhs.context,
                canonical=lhs._canonical)
        if isinstance(lhs, CSRNDArray):
            return CSRNDArray(
                NDArray._wrap(lhs.data_arr._data * float(rhs), lhs.context),
                lhs.indptr, lhs.indices, lhs.shape, ctx=lhs.context)
        return lhs * rhs
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        if lhs.shape != rhs.shape:
            raise MXNetError("sparse multiply: shape mismatch")
        key_l = _csr_to_coo_rows(lhs) * lhs.shape[1] \
            + lhs.indices.asnumpy().astype(_np.int64)
        key_r = _csr_to_coo_rows(rhs) * rhs.shape[1] \
            + rhs.indices.asnumpy().astype(_np.int64)
        common, li, ri = _np.intersect1d(key_l, key_r, return_indices=True)
        vals = lhs.data_arr.asnumpy()[li] * rhs.data_arr.asnumpy()[ri]
        return _coo_to_csr(common // lhs.shape[1], common % lhs.shape[1],
                           vals, lhs.shape, lhs.context)
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray):
        rows = _csr_to_coo_rows(lhs)
        cols = lhs.indices.asnumpy().astype(_np.int64)
        picked = rhs.asnumpy()[rows, cols]
        return CSRNDArray(lhs.data_arr.asnumpy() * picked,
                          lhs.indptr.asnumpy(), cols, lhs.shape,
                          ctx=lhs.context)
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        a, b = lhs.compact(), rhs.compact()
        common, ai, bi = _np.intersect1d(a.indices.asnumpy(),
                                         b.indices.asnumpy(),
                                         return_indices=True)
        dev = a.values._data.device
        vals = a.values._data[torch.from_numpy(ai).to(dev)] \
            * b.values._data[torch.from_numpy(bi).to(dev)]
        return RowSparseNDArray(NDArray._wrap(vals, lhs.context), common,
                                lhs.shape, ctx=lhs.context, canonical=True)
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, NDArray):
        # an (N, C) operand is gathered by row id; a (1, C) or (C,) one
        # broadcasts over the stored rows
        picked = rhs._data
        if picked.dim() == len(lhs.shape) and picked.shape[0] != 1:
            picked = picked.index_select(0, lhs.indices._data)
        return RowSparseNDArray(
            NDArray._wrap(lhs.values._data * picked, lhs.context),
            lhs.indices, lhs.shape, ctx=lhs.context,
            canonical=lhs._canonical)
    return _dense(lhs) * _dense(rhs)


def square_sum(data, axis=None, keepdims=False):
    """``sum(data ** 2)`` over the stored values only (parity:
    ``src/operator/tensor/square_sum.cc``): a row-sparse array with
    ``axis=1`` gives a row-sparse result, every other case a dense
    one."""
    ax = tuple(axis) if isinstance(axis, (tuple, list)) else \
        (axis,) if axis is not None else None
    if isinstance(data, RowSparseNDArray):
        d = data.compact()
        vals = d.values._data
        if ax == (1,) and len(data.shape) == 2:
            red = vals.square().sum(dim=1)
            if keepdims:
                red = red[:, None]
            out_shape = (data.shape[0], 1) if keepdims else (data.shape[0],)
            return RowSparseNDArray(NDArray._wrap(red, data.context),
                                    d.indices, out_shape, ctx=data.context,
                                    canonical=True)
        if ax is None:
            out = vals.square().sum()
            if keepdims:
                out = out.reshape((1,) * len(data.shape))
            return NDArray._wrap(out, data.context)
        if ax == (0,):
            # absent rows are zero, so the stored rows' sum is exact
            out = vals.square().sum(dim=0)
            if keepdims:
                out = out[None]
            return NDArray._wrap(out, data.context)
        raise MXNetError("square_sum: unsupported axis %r" % (axis,))
    if isinstance(data, CSRNDArray):
        if ax is None:
            out = data.data_arr._data.square().sum()
            if keepdims:
                out = out.reshape((1, 1))
            return NDArray._wrap(out, data.context)
        data = data.tostype("default")
    t = data._data.square()
    if ax is not None:
        return NDArray._wrap(t.sum(dim=ax, keepdim=keepdims), data.context)
    out = t.sum()
    return NDArray._wrap(out.reshape((1,) * t.dim()) if keepdims else out,
                         data.context)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``lhs . rhs`` with a CSR ``lhs`` and a dense 2-d ``rhs`` without
    densifying (parity: ``src/operator/tensor/dot.cc``'s sparse dot): O7
    (``ops/sparse_ops.csr_dot``), each stored value times the ``rhs`` row
    of its column summed into its row (with ``transpose_a``, times the
    ``rhs`` row of its row summed into its column).  Other layouts
    densify."""
    if isinstance(lhs, CSRNDArray):
        if not isinstance(rhs, NDArray):
            rhs = NDArray(rhs, ctx=lhs.context)
        if transpose_b or rhs.ndim != 2:
            return lhs.tostype("default").dot(rhs, transpose_a=transpose_a,
                                              transpose_b=transpose_b)
        out = _sops.csr_dot(lhs.data_arr._data, lhs.indptr._data,
                            lhs.indices._data, rhs._data, lhs.shape,
                            transpose_a=transpose_a)
        return NDArray._wrap(out, lhs.context)
    if isinstance(lhs, RowSparseNDArray):
        lhs = lhs.tostype("default")
    return lhs.dot(rhs, transpose_a=transpose_a, transpose_b=transpose_b)
