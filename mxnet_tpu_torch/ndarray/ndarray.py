"""NDArray: MXNet's imperative tensor, over one torch tensor.

The port's counterpart of the JAX package's ``ndarray/ndarray.py``
(reference: ``include/mxnet/ndarray.h`` and
``python/mxnet/ndarray/ndarray.py``).  An NDArray holds one tensor on
its context's device, an engine ``Var`` whose version each write bumps,
and its autograd state.  Every op goes through ``ops.registry.invoke``,
so on the card it enqueues on torch's current stream and returns;
``wait_to_read``, ``asnumpy`` and ``waitall`` are the sync points.

Where the port differs from the JAX package, deliberately:

* writes are in place: ``a += b``, ``a[1:3] = x``, ``copyto`` and
  ``out=`` write into the array's own tensor (MXNet's semantics; the JAX
  package swaps immutable buffers).  ``detach()`` shares the tensor, as
  in MXNet.  Reads by indexing return copies, as in the JAX package.
* ``dtype`` is a numpy dtype, except ``bfloat16``, which numpy lacks:
  there it is ``torch.bfloat16``, and ``asnumpy`` returns float32.
* without a context, arrays go to the current context, which is
  ``gpu(0)`` unless a ``with mx.cpu():`` scope says otherwise.
* an array made by a deferred op (engine bulking) is lazy: its tensor
  is a promise of the open bulk segment (``_pending``) until a read of
  ``_data`` flushes the segment; its shape, dtype and whether it
  requires grad are known without a flush.

* a gradient may be row-sparse: ``Embedding(sparse_grad=True)`` under
  ``record()`` gives a ``sparse.RowSparseNDArray`` (compacted), which
  ``grad`` returns.  ``write`` replaces it at each backward; ``add``
  sums two row-sparse gradients (compacted) and scatters one into a
  dense gradient; a dense gradient onto a row-sparse one densifies it
  (the JAX package's ``_accumulate_grad`` rules).
  ``attach_grad(stype="row_sparse")`` starts from an empty row-sparse
  gradient.
* dlpack exports alias the tensor on either device (no copy): a write
  through ``to_dlpack_for_write``'s capsule shows in the array at once,
  where the JAX package's shows after its next read (it writes a host
  mirror).  An export flushes a lazy array first and waits for its last
  write; the write export counts as a write to the engine.

Not ported yet (a call raises ``MXNetError`` naming the slice in
``ROADMAP.md``): sharding (``reshard``, ``with_sharding_constraint``,
``shard``, S8).
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError
from ..context import Context, as_context
from ..engine import Engine, Var
from ..ops import registry as _reg
from ..ops.tensor import to_torch_dtype


def _not_ported(what, slice_):
    raise MXNetError("%s is not ported to mxnet_tpu_torch yet (%s in "
                     "ROADMAP.md)" % (what, slice_))


def _numpy_dtype(dt):
    return dt if dt == torch.bfloat16 else \
        _np.dtype(str(dt).replace("torch.", ""))


def _host_tensor(source, dtype):
    """A fresh host tensor from numpy data, lists or scalars, with the
    JAX package's defaults: float64 → float32 and int64 → int32 when no
    dtype is asked for."""
    tdt = to_torch_dtype(dtype)
    if isinstance(source, torch.Tensor):
        t = source.detach()
    else:
        arr = _np.array(source, copy=True)
        if tdt is None and arr.dtype == _np.float64:
            arr = arr.astype(_np.float32)
        elif tdt is None and arr.dtype == _np.int64:
            arr = arr.astype(_np.int32)
        t = torch.from_numpy(arr) if arr.dtype != _np.bool_ \
            else torch.from_numpy(arr.astype(_np.uint8)).bool()
    return t if tdt is None else t.to(tdt)


class NDArray:
    """A mutable tensor on a context, with engine and autograd state."""

    # the class an op's results take when this array is its first input
    # (``mx.np.ndarray`` sets its own); NDArray below
    _op_result_cls = None

    __slots__ = ("_value", "_pending", "_ctx", "_var", "_marked", "_grad",
                 "_grad_req", "_leaf", "_stable", "__weakref__")

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data.detach()
        if isinstance(data, torch.Tensor) and ctx is None:
            ctx = Context.from_device(data.device)
        ctx = as_context(ctx)
        t = _host_tensor(data, dtype) if not isinstance(
            data, torch.Tensor) or dtype is not None else data
        dev = ctx.torch_device
        if t.device != dev:
            t = t.to(dev)
        self._data = t
        self._ctx = ctx
        self._init_rest()

    def _init_rest(self):
        self._var = Var()
        self._stable = False    # a weight or a gradient buffer: kept
        self._marked = False
        self._grad = None
        self._grad_req = "write"
        self._leaf = None

    @classmethod
    def _wrap(cls, tensor, ctx):
        """An NDArray over an op's output tensor (no copy, no checks)."""
        arr = cls.__new__(cls)
        arr._data = tensor
        arr._ctx = ctx
        arr._init_rest()
        return arr

    @classmethod
    def _lazy(cls, ref, ctx):
        """A lazy NDArray over a deferred op's output (an
        ``engine._BulkRef``)."""
        arr = cls.__new__(cls)
        arr._value = None
        arr._pending = ref
        arr._ctx = ctx
        arr._init_rest()
        return arr

    @property
    def _data(self):
        """The backing tensor; a lazy array's read flushes its segment
        (and rethrows the segment's error if that failed)."""
        p = self._pending
        if p is not None:
            self._value = p.resolve()
            self._pending = None
        return self._value

    @_data.setter
    def _data(self, tensor):
        self._value = tensor
        self._pending = None

    # ------------------------------------------------------------------
    # core accessors
    # ------------------------------------------------------------------
    def data(self):
        """The backing torch tensor (framework-internal)."""
        return self._data

    def _op_input(self, recording):
        """The tensor an op reads: inside ``record()``, a marked array
        feeds its leaf view so torch records the op."""
        data = self._data
        if recording and self._marked and data.grad_fn is None:
            return self._leaf_view()
        return data

    def _leaf_view(self):
        if self._leaf is None:
            self._leaf = self._data.detach().requires_grad_()
        return self._leaf

    def _graph_input(self):
        """What ``autograd.grad`` differentiates with respect to."""
        if self._marked and self._data.grad_fn is None:
            return self._leaf_view()
        return self._data

    def _set_data(self, new):
        """Swap in a new tensor: bump the version, drop the leaf view."""
        self._data = new
        self._leaf = None
        self._var.on_write()

    @property
    def shape(self):
        p = self._pending
        return p.shape if p is not None else tuple(self._value.shape)

    @property
    def dtype(self):
        p = self._pending
        return _numpy_dtype(p.dtype if p is not None else self._value.dtype)

    @property
    def size(self):
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def _in_graph(self):
        p = self._pending
        return self._marked or (p.requires_grad if p is not None
                                else self._value.requires_grad)

    # ------------------------------------------------------------------
    # sync / host transfer
    # ------------------------------------------------------------------
    def wait_to_read(self):
        """Wait for the op that wrote this array (rethrowing its error)."""
        Engine.get().wait_for_var(self._var, self._data.device,
                                  origin="wait_to_read")
        return self

    def asnumpy(self):
        self._var.rethrow()
        Engine.get().notify_sync("asnumpy")
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("the array is not scalar-sized")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(map(str, self.shape)), self._ctx)

    # ------------------------------------------------------------------
    # autograd
    # ------------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Mark for gradient collection (parity: ndarray.py attach_grad):
        a zero gradient buffer, filled by each ``backward``; with
        ``stype="row_sparse"`` an empty row-sparse one."""
        if stype in (None, "default"):
            buf = torch.zeros_like(self._data)
        elif stype == "row_sparse":
            from . import sparse

            buf = sparse.zeros("row_sparse", self.shape, ctx=self._ctx,
                               dtype=self._data.dtype)
        else:
            raise MXNetError("attach_grad: stype %r (default or row_sparse)"
                             % (stype,))
        self._mark(grad_req, buf)

    def _mark(self, grad_req, grad_buf):
        if grad_req not in ("write", "add", "null"):
            raise MXNetError("grad_req %r (write, add or null)" % grad_req)
        if self._data.requires_grad:
            self._data = self._data.detach()
        self._marked = self._stable = True
        self._grad_req = grad_req
        self._grad = None if grad_req == "null" else grad_buf
        self._leaf = None
        autograd._marked[id(self)] = self

    def _write_grad(self, g):
        """One backward's gradient, written by ``grad_req``: a torch sparse
        COO gradient is kept row-sparse (see the module docstring)."""
        if self._grad_req == "null":
            return
        from .sparse import RowSparseNDArray

        prev = self._grad
        add = self._grad_req == "add" and prev is not None
        if g.is_sparse:
            rsp = RowSparseNDArray._from_torch(g.to(self._data.dtype),
                                               self._ctx)
            if not add:
                self._grad = rsp
            elif isinstance(prev, RowSparseNDArray):
                self._grad = prev + rsp
            else:
                Engine.get().flush_if_referencing((prev,), "grad")
                prev.index_add_(0, rsp.indices._data, rsp.values._data)
            return
        g = g.to(self._data.dtype)
        if isinstance(prev, RowSparseNDArray):
            self._grad = prev.tostype("default")._data + g if add \
                else g.clone()
            return
        if prev is not None:
            Engine.get().flush_if_referencing((prev,), "grad")
        if prev is None or prev.shape != g.shape:
            self._grad = g.clone()
        elif add:
            prev.add_(g)
        else:
            prev.copy_(g)

    @property
    def grad(self):
        if self._grad is None:
            return None
        if not isinstance(self._grad, torch.Tensor):
            return self._grad       # row-sparse
        g = NDArray._wrap(self._grad, self._ctx)
        g._stable = True
        return g

    def zero_grad(self):
        if self._grad is None:
            return
        if not isinstance(self._grad, torch.Tensor):
            from . import sparse

            self._grad = sparse.zeros("row_sparse", self.shape,
                                      ctx=self._ctx, dtype=self._data.dtype)
            return
        Engine.get().flush_if_referencing((self._grad,), "grad")
        self._grad.zero_()

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self):
        """A new array of this array's class over the same tensor,
        outside any graph."""
        return self._op_result_cls._wrap(self._data.detach(), self._ctx)

    def as_nd_ndarray(self):
        """This array as a classic ``mx.nd`` NDArray (itself here;
        ``mx.np.ndarray`` gives a view over the same tensor)."""
        return self

    # ------------------------------------------------------------------
    # conversion / copies
    # ------------------------------------------------------------------
    def astype(self, dtype, copy=True):
        tdt = to_torch_dtype(dtype)
        if not copy and self._data.dtype == tdt:
            return self
        return _reg.invoke("cast", [self], {"dtype": tdt})

    def copy(self):
        return _reg.invoke("identity", [self])

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, in place) or onto a context."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError("copyto shape mismatch")
            src = self._data.detach()
            Engine.get().push(
                lambda: other._data.copy_(src), (self._var,),
                (other._var,), op_name="copyto", device=other._data.device)
            return other
        if isinstance(other, (Context, torch.device, str)):
            return self.as_in_context(other)
        raise TypeError("copyto target must be NDArray or Context")

    def as_in_context(self, context):
        ctx = as_context(context)
        if ctx == self._ctx:
            return self
        dev = ctx.torch_device
        (out,) = _reg.invoke_fn(lambda d: (d.to(dev),), [self],
                                op_name="_copyto", ctx=ctx)
        return out

    as_in_ctx = as_in_context

    def tostype(self, stype):
        """This array in ``stype`` storage: itself for ``"default"``, a
        ``sparse.RowSparseNDArray`` or ``sparse.CSRNDArray`` view of its
        values otherwise."""
        if stype != "default":
            from . import sparse

            return sparse.dense_to(self, stype)
        return self

    def reshard(self, spec=None, mesh=None):
        _not_ported("NDArray.reshard", "S8")

    def with_sharding_constraint(self, spec=None, mesh=None):
        _not_ported("NDArray.with_sharding_constraint", "S8")

    # ------------------------------------------------------------------
    # DLPack (reference ndarray.py:2825-2893): the export aliases the
    # tensor on either device
    # ------------------------------------------------------------------
    def _dlpack_tensor(self, write):
        """The tensor to export, once its last write is done (a lazy
        array flushes first); a write export bumps the version and flushes
        the open segment where it reads this tensor."""
        data = self._data
        self.wait_to_read()
        if write:
            Engine.get().flush_if_referencing((data,), "dlpack")
            self._var.on_write()
        return data.detach()

    def __dlpack__(self, **kwargs):
        return self._dlpack_tensor(False).__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def to_dlpack_for_read(self):
        """A DLPack capsule over this array's tensor (no copy); no writes
        through it."""
        return torch.utils.dlpack.to_dlpack(self._dlpack_tensor(False))

    def to_dlpack_for_write(self):
        """A DLPack capsule over this array's tensor (no copy): what is
        written through it shows in the array at once."""
        return torch.utils.dlpack.to_dlpack(self._dlpack_tensor(True))

    # ------------------------------------------------------------------
    # shape ops (method forms)
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape and "shape" in kwargs:
            shape = tuple(kwargs["shape"])
        return _reg.invoke("reshape", [self], {"shape": tuple(shape)})

    def reshape_like(self, other):
        return _reg.invoke("reshape_like", [self, other])

    def flatten(self):
        return _reg.invoke("flatten", [self])

    def expand_dims(self, axis):
        return _reg.invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _reg.invoke("squeeze", [self], {"axis": axis})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _reg.invoke("transpose", [self], {"axes": axes or None})

    @property
    def T(self):
        return self.transpose()

    def swapaxes(self, dim1, dim2):
        return _reg.invoke("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def broadcast_to(self, shape):
        return _reg.invoke("broadcast_to", [self], {"shape": tuple(shape)})

    def broadcast_like(self, other):
        return _reg.invoke("broadcast_like", [self, other])

    def tile(self, reps):
        return _reg.invoke("tile", [self], {"reps": tuple(reps)})

    def slice(self, begin, end, step=None):
        return _reg.invoke("slice", [self],
                           {"begin": tuple(begin), "end": tuple(end),
                            "step": tuple(step) if step else ()})

    def slice_axis(self, axis, begin, end):
        return _reg.invoke("slice_axis", [self],
                           {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return _reg.invoke("take", [self, _as_nd(indices, self._ctx)],
                           {"axis": axis, "mode": mode})

    def flip(self, axis):
        return _reg.invoke("reverse", [self], {"axis": axis})

    def pad(self, mode, pad_width, constant_value=0.0):
        return _reg.invoke("pad", [self],
                           {"mode": mode, "pad_width": tuple(pad_width),
                            "constant_value": constant_value})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _reg.invoke("split", [self],
                           {"num_outputs": num_outputs, "axis": axis,
                            "squeeze_axis": squeeze_axis})

    # reductions and elementwise functions as methods
    def _reduce(self, op, axis, keepdims):
        return _reg.invoke(op, [self], {"axis": axis, "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _reg.invoke("norm", [self],
                           {"ord": ord, "axis": axis, "keepdims": keepdims})

    def clip(self, a_min, a_max):
        return _reg.invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def abs(self):
        return _reg.invoke("abs", [self])

    def sign(self):
        return _reg.invoke("sign", [self])

    def sqrt(self):
        return _reg.invoke("sqrt", [self])

    def square(self):
        return _reg.invoke("square", [self])

    def exp(self):
        return _reg.invoke("exp", [self])

    def log(self):
        return _reg.invoke("log", [self])

    def relu(self):
        return _reg.invoke("relu", [self])

    def sigmoid(self):
        return _reg.invoke("sigmoid", [self])

    def tanh(self):
        return _reg.invoke("tanh", [self])

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _reg.invoke("dot", [self, other],
                           {"transpose_a": transpose_a,
                            "transpose_b": transpose_b})

    def softmax(self, axis=-1, temperature=None):
        return _reg.invoke("softmax", [self], {"axis": axis,
                                               "temperature": temperature})

    def log_softmax(self, axis=-1, temperature=None):
        return _reg.invoke("log_softmax", [self],
                           {"axis": axis, "temperature": temperature})

    def one_hot(self, depth, **kwargs):
        kwargs["depth"] = depth
        return _reg.invoke("one_hot", [self], kwargs)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _reg.invoke("topk", [self],
                           {"axis": axis, "k": k, "ret_typ": ret_typ,
                            "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return _reg.invoke("sort", [self], {"axis": axis,
                                            "is_ascend": is_ascend})

    def argsort(self, axis=-1, is_ascend=True):
        return _reg.invoke("argsort", [self], {"axis": axis,
                                               "is_ascend": is_ascend})

    # ------------------------------------------------------------------
    # arithmetic operators
    # ------------------------------------------------------------------
    def _binary(self, other, op, scalar_op, rscalar_op=None, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return _reg.invoke(op, [a, b])
        if isinstance(other, (int, float, bool, _np.number)):
            name = (rscalar_op or scalar_op) if reverse else scalar_op
            return _reg.invoke(name, [self], {"scalar": float(other)})
        if isinstance(other, (_np.ndarray, list, tuple)):
            return self._binary(NDArray(other, ctx=self._ctx), op, scalar_op,
                                rscalar_op, reverse)
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    def __radd__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar", reverse=True)

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar",
                            "_rminus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar",
                            "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    def __rmul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar", reverse=True)

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar",
                            "_rdiv_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar",
                            "_rdiv_scalar", reverse=True)

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar",
                            "_rmod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar",
                            "_rmod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar",
                            "_rpower_scalar")

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar",
                            "_rpower_scalar", reverse=True)

    def __neg__(self):
        return _reg.invoke("negative", [self])

    def __abs__(self):
        return _reg.invoke("abs", [self])

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    __hash__ = None  # mutable; matches reference NDArray unhashability

    # in-place: into this array's own tensor; inside record() an array in
    # the graph takes the recorded result instead (as MXNet's += does)
    def _inplace(self, o, method, dunder):
        if autograd.is_recording() and (
                self._in_graph or getattr(o, "_in_graph", False)):
            self._adopt(dunder(self, o))
            return self
        other = o._data if isinstance(o, NDArray) else o
        if isinstance(other, (_np.ndarray, list, tuple)):
            other = _host_tensor(other, None).to(self._data.device)
        try:
            ok = torch.result_type(self._data, other) == self._data.dtype \
                and torch.broadcast_shapes(
                    getattr(other, "shape", ()), self.shape) == self.shape
        except RuntimeError:      # shapes that do not broadcast
            ok = False
        if not ok:
            self._adopt(dunder(self, o))
            return self
        reads = (self._var, o._var) if isinstance(o, NDArray) else \
            (self._var,)
        with torch.no_grad():
            Engine.get().push(lambda: getattr(self._data, method)(other),
                              reads, (self._var,), op_name=method,
                              device=self._data.device)
        return self

    def __iadd__(self, o):
        return self._inplace(o, "add_", NDArray.__add__)

    def __isub__(self, o):
        return self._inplace(o, "sub_", NDArray.__sub__)

    def __imul__(self, o):
        return self._inplace(o, "mul_", NDArray.__mul__)

    def __itruediv__(self, o):
        return self._inplace(o, "div_", NDArray.__truediv__)

    def _adopt(self, res):
        """Take ``res``'s value: copied into this array's tensor when
        neither carries a graph and the shapes and types agree, else by
        taking ``res``'s tensor (and graph)."""
        if not res._data.requires_grad and not self._data.requires_grad \
                and res._data.shape == self._data.shape \
                and res._data.dtype == self._data.dtype \
                and res._data.device == self._data.device:
            Engine.get().flush_if_referencing((self._data,), "adopt")
            with torch.no_grad():
                self._data.copy_(res._data)
            self._var.on_write()
        else:
            self._set_data(res._data)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def _conv_index(self, key):
        if isinstance(key, NDArray):
            return self._index_tensor(key)
        if isinstance(key, tuple):
            return tuple(self._index_tensor(k) if isinstance(k, NDArray)
                         else k for k in key)
        return key

    @staticmethod
    def _index_tensor(k):
        d = k._data
        return d.long() if d.is_floating_point() or d.dtype == torch.int32 \
            else d

    def __getitem__(self, key):
        """A copy of the indexed part (recorded inside ``record()``).  A
        slice with a negative step reads the same elements through the
        positive step and flips them (torch takes no negative step)."""
        key = self._conv_index(key)
        key, flips = _positive_steps(key, self.shape)
        if any(isinstance(k, torch.Tensor) and k.dtype == torch.bool
               for k in (key if isinstance(key, tuple) else (key,))):
            from ..graph_cache import refuse_host_read

            refuse_host_read("boolean-mask indexing", self._data)
        (out,) = _reg.invoke_fn(
            lambda d: (d[key].flip(flips) if flips else d[key].clone(),),
            [self], op_name="_index")
        return out

    def __setitem__(self, key, value):
        if autograd.is_recording() and self._in_graph:
            raise MXNetError("in-place assignment on a taped array")
        key, flips = _positive_steps(self._conv_index(key), self.shape)
        reads = (self._var,)
        if isinstance(value, NDArray):
            reads += (value._var,)
            value = value._data.detach()
        elif not isinstance(value, (int, float, bool)):
            value = _host_tensor(value, None)
        if isinstance(value, torch.Tensor):
            value = value.to(self._data.device, self._data.dtype)

        def write():
            with torch.no_grad():
                if flips and isinstance(value, torch.Tensor):
                    dst = self._data[key]
                    dst.copy_(torch.broadcast_to(value, dst.shape).flip(flips))
                else:
                    self._data[key] = value

        Engine.get().push(write, reads, (self._var,), op_name="_setitem",
                          device=self._data.device)


NDArray._op_result_cls = NDArray


def _positive_steps(key, shape):
    """``key`` with each negative-step slice replaced by the positive-step
    slice over the same elements, and the dims of the result to flip to
    put them back in the slice's order (empty when no step is negative).
    Negative steps are taken in basic indexing: ints, slices, ``None``
    and ``...``."""
    items = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in items):
        return key, ()
    if not all(k is None or k is Ellipsis or isinstance(k, slice)
               or isinstance(k, (int, _np.integer)) for k in items):
        raise MXNetError("a negative-step slice with an array index is not "
                         "supported: index with the slice first")
    out, flips, src, res = [], [], 0, 0
    for k in items:
        if k is Ellipsis:
            span = len(shape) - sum(1 for i in items
                                    if i is not None and i is not Ellipsis)
            src, res = src + span, res + span
        elif k is None:
            res += 1
        elif isinstance(k, slice):
            if k.step is not None and k.step < 0:
                idx = range(*k.indices(shape[src]))
                if len(idx):
                    k = slice(idx[-1], idx[0] + 1, -k.step)
                    flips.append(res)
                else:
                    k = slice(0, 0)
            src, res = src + 1, res + 1
        else:
            src += 1
        out.append(k)
    return tuple(out), tuple(flips)


def _as_nd(x, ctx=None):
    if isinstance(x, NDArray):
        return x
    return NDArray(x, ctx=ctx)


def shard(arr, spec=None, mesh=None):
    _not_ported("nd.shard", "S8")


def from_dlpack(obj):
    """An NDArray over a DLPack-capable object or a legacy capsule
    (parity: reference ``ndarray.py:2878-2893``): no copy where torch can
    read the producer's memory, on the producer's device."""
    if isinstance(obj, NDArray):
        return obj
    return NDArray(torch.utils.dlpack.from_dlpack(obj))


def to_dlpack_for_read(data):
    """Module-level form of ``NDArray.to_dlpack_for_read``."""
    return data.to_dlpack_for_read()


def to_dlpack_for_write(data):
    """Module-level form of ``NDArray.to_dlpack_for_write``."""
    return data.to_dlpack_for_write()


# ----------------------------------------------------------------------------
# creation helpers (parity: python/mxnet/ndarray/utils.py + ndarray.py)
# ----------------------------------------------------------------------------


def array(source_array, ctx=None, dtype=None):
    """A new array holding a copy of ``source_array`` (numpy data, a list,
    a scalar, a tensor or an NDArray), as MXNet's ``nd.array`` does: a
    later in-place write to either leaves the other alone."""
    out = NDArray(source_array, ctx=ctx, dtype=dtype)
    src = source_array._data if isinstance(source_array, NDArray) \
        else source_array
    if isinstance(src, torch.Tensor) and \
            out._data.data_ptr() == src.data_ptr():
        out._data = out._data.clone()
    return out


def _create(op, shape, ctx, dtype, **attrs):
    if isinstance(shape, int):
        shape = (shape,)
    return _reg.invoke(op, [], dict(attrs, shape=tuple(shape),
                                    dtype=dtype or "float32", ctx=ctx))


def empty(shape, ctx=None, dtype=None):
    """An uninitialized array (MXNet's semantics; the JAX package returns
    zeros): for outputs that a kernel writes in full."""
    if isinstance(shape, int):
        shape = (shape,)
    ctx = as_context(ctx)
    return NDArray._wrap(torch.empty(
        tuple(shape), dtype=to_torch_dtype(dtype or "float32"),
        device=ctx.torch_device), ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _create("_zeros", shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _create("_ones", shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=None):
    return _create("_full", shape, ctx, dtype, value=val)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return _reg.invoke("_arange", [], {
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "dtype": dtype or "float32", "ctx": ctx})


def zeros_like(a):
    return _reg.invoke("zeros_like", [a])


def ones_like(a):
    return _reg.invoke("ones_like", [a])


def concatenate(arrays, axis=0, always_copy=True):
    return _reg.invoke("concat", list(arrays), {"dim": axis})


def moveaxis(tensor, source, destination):
    axes = list(range(tensor.ndim))
    axes.remove(source % tensor.ndim)
    axes.insert(destination % tensor.ndim, source % tensor.ndim)
    return tensor.transpose(axes)


def waitall():
    Engine.get().wait_for_all()


# ----------------------------------------------------------------------------
# .params files (parity: ndarray.py save/load over legacy_io)
# ----------------------------------------------------------------------------


def save_arrays(fname, data):
    """Write numpy arrays (one, a list or a dict) as a ``.params`` file:
    the reference's binary container (``legacy_io``), written atomically
    through ``base.atomic_path``.  A bf16 array is written as f32 with
    flag 0, as the JAX package writes it, so one set of values gives the
    same bytes from either package."""
    from ..base import atomic_path
    from . import legacy_io

    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        arrays, names = list(data), []
    else:
        arrays, names = [data], []
    with atomic_path(fname) as tmp:
        legacy_io.save_params(tmp, arrays, names)


def save(fname, data):
    """Save an NDArray, a list or a dict of NDArrays (parity:
    MXNDArraySave; files cross between the packages both ways)."""
    if isinstance(data, NDArray):
        save_arrays(fname, [data.asnumpy()])
    elif isinstance(data, (list, tuple)):
        save_arrays(fname, [a.asnumpy() for a in data])
    elif isinstance(data, dict):
        save_arrays(fname, {k: v.asnumpy() for k, v in data.items()})
    else:
        raise TypeError("unsupported save payload")


def load_arrays(fname):
    """What :func:`save_arrays` (or the JAX package's ``nd.save``, in
    either of its containers: the reference binary one or the earlier
    ``.npz``) wrote, as numpy arrays: a dict when the file names its
    arrays, else a list (a single array for an ``.npz`` of one)."""
    from . import legacy_io

    if legacy_io.is_legacy_file(fname):
        arrays, names = legacy_io.load_params(fname)
        return dict(zip(names, arrays)) if names else arrays
    with _np.load(fname, allow_pickle=False) as z:
        kind = str(z["__kind__"])
        if kind == "single":
            return z["arr_0"]
        if kind == "list":
            n = len([k for k in z.files if k.startswith("arr_")])
            return [z["arr_%d" % i] for i in range(n)]
        return {k[4:]: z[k] for k in z.files if k.startswith("key:")}


def load(fname, ctx=None):
    """Load what :func:`save` wrote as NDArrays on ``ctx`` (default: the
    current context)."""
    out = load_arrays(fname)
    if isinstance(out, dict):
        return {k: NDArray(a, ctx=ctx) for k, a in out.items()}
    if isinstance(out, list):
        return [NDArray(a, ctx=ctx) if a is not None else None
                for a in out]
    return NDArray(out, ctx=ctx)
