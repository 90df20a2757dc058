"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` (the port's
counterpart of ``mxnet_tpu/gluon/parameter.py``).

A ``Parameter`` is a handle over one tensor that a block registers: a
``torch.nn.Parameter``, or a buffer for the running statistics of
``nn.BatchNorm``.  The tensor stays the module's own, so
``state_dict()``, the captured graphs, ``JitTrainStep`` and the
multi-tensor updates read and write it as before; the handle carries
what the JAX package's parameter carries beside its data: the prefixed
``name``, ``grad_req``, ``lr_mult``, ``wd_mult``, ``init``, ``dtype``
and ``shape`` (0 for a dimension not known yet, with
``allow_deferred_init``).  The tensor is made when a block registers
the handle or ``initialize`` runs, on the device the handle was given
(default: the current context), uninitialized
(``torch.nn.parameter.UninitializedParameter``) while its shape is not
known.

``grad_req`` maps onto torch: ``"null"`` turns ``requires_grad`` off,
so no gradient is made and ``JitTrainStep``, the graph pair and
``gluon.Trainer`` leave the tensor out; ``"write"`` (the default) has
each backward through a block's call overwrite ``.grad``
(``block.write_grads``); ``"add"`` lets torch add each backward's
gradient to ``.grad`` until ``zero_grad``.  The tensor carries the rule
as ``_grad_req``, which the write rule reads when a backward reaches it,
so a change takes effect on the next backward.

``data()`` and ``grad()`` return NDArrays over the tensor and its
``.grad`` (the same storage); ``grad()`` gives zeros while no backward
has reached the tensor.  ``set_data`` copies in place, so a captured
graph reads the new value.  One device only: ``list_data()`` has one
entry and ``reset_ctx`` moves the tensor.

A block's attribute (``dense.weight``, ``bn.running_mean``) is the
registered tensor, and works as the handle too: once a handle holds it,
its class becomes ``GluonParameter`` (a ``torch.nn.Parameter``) or
``GluonBuffer``, whose ``.data`` and ``.grad`` are what torch gives and
are also callable as the handle's ``data()`` and ``grad()``, and whose
``set_data`` is the handle's.  Nothing else changes: ops on them give
plain tensors, and torch's own ``.data``/``.grad`` reads and writes go
through unchanged.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as _np
import torch

from .. import graph_cache as _graph_cache
from .. import initializer as init_mod
from ..base import MXNetError
from ..context import Context, as_context
from .utils import shape_is_known

_LAZY = torch.nn.parameter.UninitializedTensorMixin
_TENSOR_DATA = torch._C.TensorBase.data
_TENSOR_GRAD = torch._C.TensorBase.grad
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}


def as_dtype(dtype):
    """A ``torch.dtype`` from a dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype) if not isinstance(dtype, type) \
        else _np.dtype(dtype).name
    try:
        return _DTYPES[name.replace("torch.", "")]
    except KeyError:
        raise MXNetError("unsupported dtype %r (one of %s)"
                         % (dtype, sorted(_DTYPES)))


def dtype_name(dtype):
    """The JAX package's name of a dtype (``"float32"``, ``"bfloat16"``)."""
    return str(as_dtype(dtype)).replace("torch.", "")


class _CallableTensor(torch.Tensor):
    """What ``.data`` and ``.grad`` of a block's tensor give: the tensor
    torch gives, also callable as its handle's ``data()``/``grad()``."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __call__(self, ctx=None):
        ref, kind = self._mx_call
        return getattr(_handle(ref), kind)(ctx)


def _handle(ref):
    """The handle behind a weak reference (a tensor holds its handle
    weakly: the handle holds the tensor, and a cycle through a tensor's
    attributes is not collected)."""
    handle = ref()
    if handle is None:
        raise MXNetError("this tensor's gluon Parameter no longer exists")
    return handle


class _GluonTensor:
    """``.data``/``.grad`` callable and ``set_data`` for a tensor that a
    ``Parameter`` handle holds (``_mx_handle``, a weak reference); see the
    module docstring."""

    @property
    def data(self):
        d = _TENSOR_DATA.__get__(self)
        d.__class__ = _CallableTensor
        d._mx_call = (self._mx_handle, "data")
        return d

    @data.setter
    def data(self, value):
        _TENSOR_DATA.__set__(self, value)

    @property
    def grad(self):
        g = _TENSOR_GRAD.__get__(self)
        if g is not None and type(g) is not _CallableTensor:
            g.__class__ = _CallableTensor
            g._mx_call = (self._mx_handle, "grad")
        return g

    @grad.setter
    def grad(self, value):
        _TENSOR_GRAD.__set__(self, value)

    def set_data(self, data):
        _handle(self._mx_handle).set_data(data)


class GluonParameter(_GluonTensor, torch.nn.Parameter):
    """A block's registered ``torch.nn.Parameter`` once a handle holds
    it."""

    def __repr__(self):
        return "Parameter containing:\n" + repr(_TENSOR_DATA.__get__(self))


class GluonBuffer(_GluonTensor, torch.Tensor):
    """A block's registered buffer (running statistics) once a handle
    holds it."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __repr__(self):
        return repr(_TENSOR_DATA.__get__(self))


def _as_gluon(tensor, handle):
    """Give ``tensor`` its handle and, if it is a plain parameter or
    buffer, the class whose ``.data``/``.grad`` are callable."""
    tensor._mx_handle = weakref.ref(handle)
    if type(tensor) is torch.nn.Parameter:
        tensor.__class__ = GluonParameter
    elif type(tensor) is torch.Tensor:
        tensor.__class__ = GluonBuffer


class DeferredInitializationError(MXNetError):
    """A parameter was read before its shape was known (parity:
    parameter.py DeferredInitializationError)."""


class Parameter:
    """A weight, bias or running statistic of a block (parity:
    gluon.Parameter).  ``shape`` entries of 0 are known at the first
    forward (``allow_deferred_init``).  ``device`` (port only) is where
    the tensor is made; by default the current context's device."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default", device=None):
        if stype != "default" or grad_stype != "default":
            raise MXNetError("Parameter(stype=%r, grad_stype=%r): sparse "
                             "storage is not ported yet (S7 in ROADMAP.md)"
                             % (stype, grad_stype))
        self.name = name
        req = grad_req if differentiable else "null"
        _check_req(req)
        self._grad_req = req
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._init = init
        self.allow_deferred_init = allow_deferred_init
        self._device = device
        self._tensor = None        # the torch tensor a block registers
        self._buffer = False       # a buffer (running statistics)
        self._deferred_init = None  # (init, default_init, generator)
        self._nd = None            # the NDArray data() hands out
        # a channels-last convolution's weight: OIHW here, HWIO in a
        # .params file (as the JAX package keeps it)
        self._file_layout = None
        # a weak method of the owner, run once the shape is known
        self._on_materialize = None

    # -- the tensor ---------------------------------------------------------
    def _ensure_tensor(self):
        """The tensor, made now if it does not exist yet."""
        if self._tensor is None:
            dev = as_context(self._device).torch_device \
                if not isinstance(self._device, torch.device) \
                else self._device
            dt = as_dtype(self._dtype)
            req = self._grad_req != "null"
            if self._buffer:
                t = torch.empty(self._shape, dtype=dt, device=dev) \
                    if shape_is_known(self._shape) else \
                    torch.nn.parameter.UninitializedBuffer(device=dev,
                                                           dtype=dt)
            elif shape_is_known(self._shape):
                t = torch.nn.Parameter(
                    torch.empty(self._shape, dtype=dt, device=dev),
                    requires_grad=req)
            else:
                t = torch.nn.parameter.UninitializedParameter(
                    requires_grad=req, device=dev, dtype=dt)
            self._attach(t)
        return self._tensor

    def _attach(self, tensor):
        """Make ``tensor`` this handle's (a block registered it)."""
        tensor.init = self._init
        tensor._grad_req = self._grad_req
        _as_gluon(tensor, self)
        self._tensor = tensor
        self._nd = None

    @property
    def _lazy(self):
        return self._tensor is None or isinstance(self._tensor, _LAZY)

    @property
    def _data(self):
        """The tensor once it holds values, else None (the JAX
        package's ``_data``)."""
        t = self._tensor
        if t is None or isinstance(t, _LAZY) \
                or not getattr(t, "_initialized", False):
            return None
        return t

    # -- attributes ---------------------------------------------------------
    @property
    def shape(self):
        if not self._lazy:
            return tuple(self._tensor.shape)
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and (
                len(self._shape) != len(new_shape) or any(
                    a != b for a, b in zip(self._shape, new_shape)
                    if a != 0)):
            raise MXNetError("cannot reset shape of %s from %s to %s"
                             % (self.name, self._shape, new_shape))
        if not self._lazy and tuple(self._tensor.shape) != new_shape:
            raise MXNetError("cannot reset shape of %s from %s to %s"
                             % (self.name, tuple(self._tensor.shape),
                                new_shape))
        self._shape = new_shape

    @property
    def dtype(self):
        if self._tensor is not None:
            return dtype_name(self._tensor.dtype)
        return self._dtype

    @dtype.setter
    def dtype(self, dtype):
        self._dtype = dtype_name(dtype)

    @property
    def init(self):
        return self._init

    @init.setter
    def init(self, init):
        self._init = init
        if self._tensor is not None:
            self._tensor.init = init

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        _check_req(req)
        if self._buffer and req != "null":
            raise MXNetError("%s is a running statistic: it takes no "
                             "gradient (grad_req 'null')" % self.name)
        self._grad_req = req
        t = self._tensor
        if t is None:
            return
        t._grad_req = req
        if t.is_floating_point():
            t.requires_grad_(req != "null")
        if req == "null":
            t.grad = None

    # -- initialization -----------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Fill the tensor from ``init``, else the parameter's own
        ``init``, else ``default_init`` (default ``Uniform()``), drawing
        from ``generator``; a parameter whose shape is not known yet is
        filled when it is (parity: Parameter.initialize)."""
        if self._data is not None and not force_reinit:
            return
        if default_init is None:
            default_init = init_mod.Uniform()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        if ctx is not None and self._tensor is None:
            self._device = ctx
        if not shape_is_known(self.shape):
            if self.allow_deferred_init:
                self._ensure_tensor()
                self._deferred_init = (init, default_init, generator)
                return
            raise MXNetError(
                "cannot initialize parameter %s of unknown shape %s; set "
                "allow_deferred_init=True or specify the full shape"
                % (self.name, self.shape))
        if self._lazy:
            self._ensure_tensor()
            if self._lazy:
                self._materialize(self._shape)
        self._fill(init, default_init, generator)

    def _initializer(self, init, default_init):
        if init is not None:
            return init_mod.create(init)
        if self._init is not None:
            return init_mod.create(self._init)
        return init_mod.create(default_init)

    def _fill(self, init, default_init, generator):
        """Fill the tensor in place.  A bf16 or f16 tensor is drawn in
        f32 and rounded once, as the JAX package draws (so a parameter
        cast before its deferred fill gets the values of one cast
        after it)."""
        t = self._tensor
        initializer = self._initializer(init, default_init)
        with torch.no_grad():
            if t.dtype in (torch.bfloat16, torch.float16):
                full = torch.empty(t.shape, dtype=torch.float32,
                                   device=t.device)
                t.data.copy_(initializer(self.name, full,
                                         generator=generator))
            else:
                initializer(self.name, t.data, generator=generator)
        t._initialized = True
        self._deferred_init = None

    def _materialize(self, shape):
        """Give a deferred tensor its shape, unfilled (the object, and
        so every module that registered it, kept)."""
        self.shape = shape
        t = self._tensor
        init = t.init
        t.materialize(tuple(shape))
        t.init = init
        t._grad_req = self._grad_req
        _as_gluon(t, self)
        hook = self._on_materialize and self._on_materialize()
        if hook is not None:
            hook()
        _graph_cache.tree_changed()

    def _finish_deferred_init(self):
        """Materialize and fill a deferred parameter once its shape is
        known (parity: Parameter._finish_deferred_init)."""
        if self._deferred_init is None:
            return
        if not shape_is_known(self._shape):
            raise DeferredInitializationError(
                "parameter %s still has unknown shape %s"
                % (self.name, self._shape))
        if self._lazy:
            self._materialize(self._shape)
        self._fill(*self._deferred_init)

    # -- access -------------------------------------------------------------
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                "parameter %s was not initialized yet: unknown shape %s"
                % (self.name, self.shape))
        raise MXNetError("parameter %s has not been initialized; call "
                         ".initialize() or block.initialize()" % self.name)

    def _context(self):
        return Context.from_device(self._tensor.device)

    def data(self, ctx=None):
        """The parameter as an NDArray over the tensor itself."""
        from ..ndarray.ndarray import NDArray

        self._check_initialized()
        nd = self._nd
        if nd is None or nd._value is not self._tensor:
            nd = NDArray._wrap(self._tensor, self._context())
            nd._stable = True
            self._nd = nd
        return nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient as an NDArray over ``.grad`` (zeros while no
        backward has reached the tensor)."""
        from ..ndarray.ndarray import NDArray

        self._check_initialized()
        if self._grad_req == "null":
            raise MXNetError("parameter %s has grad_req='null'" % self.name)
        g = self._tensor.grad
        if g is None:
            return NDArray._wrap(torch.zeros_like(self._tensor),
                                 self._context())
        out = NDArray._wrap(g, self._context())
        out._stable = True
        return out

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._tensor is None:
            if self._deferred_init is not None or self._device is not None:
                return [as_context(self._device)]
            raise MXNetError("parameter %s not initialized" % self.name)
        return [self._context()]

    def set_data(self, data):
        """Copy ``data`` into the tensor in place (in its dtype); a
        deferred parameter takes its shape from ``data`` first."""
        if self._data is None:
            if self._deferred_init is not None:
                self.shape = tuple(data.shape)
                self._finish_deferred_init()
            elif self._tensor is None or self._lazy:
                raise MXNetError("parameter %s not initialized" % self.name)
        t = self._tensor
        src = _as_tensor(data)
        if tuple(src.shape) != tuple(t.shape):
            raise MXNetError("set_data: %s has shape %s, the data %s"
                             % (self.name, tuple(t.shape),
                                tuple(src.shape)))
        with torch.no_grad():
            t.copy_(src)
        t._initialized = True
        if self._nd is not None:
            self._nd._var.on_write()

    def _file_array(self):
        """The values as a ``.params`` file holds them: numpy, bf16 as
        f32, a channels-last convolution's weight as HWIO."""
        a = self.data().asnumpy()
        if self._file_layout == "hwio":
            a = a.transpose(*range(2, a.ndim), 1, 0)
        return a

    def _set_file_array(self, arr):
        """Take the values of a ``.params`` entry (the inverse of
        :meth:`_file_array`); a deferred tensor takes its shape."""
        a = arr.asnumpy() if hasattr(arr, "asnumpy") else _np.asarray(arr)
        if self._file_layout == "hwio":
            n = a.ndim - 2
            a = a.transpose(n + 1, n, *range(n))
        if self._lazy:
            self._ensure_tensor()
            if self._lazy:
                self._materialize(a.shape)
            self._deferred_init = None
        self.set_data(a)

    def zero_grad(self):
        """Zero the gradient in place (an ``"add"`` parameter then adds
        from zero)."""
        t = self._tensor
        if t is not None and t.grad is not None:
            with torch.no_grad():
                t.grad.zero_()

    def reset_ctx(self, ctx):
        """Move the tensor (and its gradient) to ``ctx``: one device."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        self._device = ctx
        t = self._tensor
        if t is None or self._lazy:
            return
        dev = as_context(ctx).torch_device
        grad = t.grad
        with torch.no_grad():
            t.data = t.data.to(dev)
            if grad is not None:
                t.grad = grad.to(dev)
        _graph_cache.tree_changed()

    def cast(self, dtype):
        """Cast the tensor's data to ``dtype`` in place of the object."""
        self._dtype = dtype_name(dtype)
        t = self._tensor
        if t is None:
            return
        dt = as_dtype(dtype)
        if isinstance(t, _LAZY):
            t.data = torch.empty(0, dtype=dt, device=t.device)
        elif t.is_floating_point():
            t.data = t.data.to(dt)
            if t.grad is not None:
                t.grad = t.grad.to(dt)

    def var(self):
        raise MXNetError("Parameter.var(): the symbolic API is not ported "
                         "yet (S9 in ROADMAP.md)")

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)


def _check_req(req):
    if req not in ("write", "add", "null"):
        raise MXNetError("invalid grad_req %r (write, add or null)" % (req,))


def _as_tensor(data):
    """A tensor from an NDArray (flushed), a tensor or array-like data."""
    from ..ndarray.ndarray import NDArray

    if isinstance(data, NDArray):
        return data._data.detach()
    if isinstance(data, torch.Tensor):
        return data.detach()
    arr = _np.asarray(data)
    return torch.from_numpy(_np.ascontiguousarray(arr))


class _ValueInit(init_mod.Initializer):
    """A ``Constant``'s value, whatever the parameter's name."""

    def __init__(self, value):
        super().__init__()
        self.value = value

    def __call__(self, name, tensor, generator=None):
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(self.value))
        return tensor


class Constant(Parameter):
    """A parameter that takes no gradient and holds ``value`` (parity:
    gluon.Constant): float64 values are kept as float32 and int64 as
    int32, as in the JAX package."""

    def __init__(self, name, value, device=None):
        from ..ndarray.ndarray import NDArray

        if isinstance(value, NDArray):
            value = value.asnumpy()
        value = _np.array(value)
        if value.dtype == _np.float64:
            value = value.astype(_np.float32)
        elif value.dtype == _np.int64:
            value = value.astype(_np.int32)
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=str(value.dtype), init=_ValueInit(value),
                         device=device)


class ParameterDict:
    """Ordered name -> Parameter mapping with a prefix and a shared dict
    to look names up in (parity: gluon.ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, name):
        return name in self._params

    def __getitem__(self, name):
        return self._params[name]

    def __repr__(self):
        body = "\n".join("  %s" % p for p in self._params.values())
        return "ParameterDict '%s' (\n%s\n)" % (self._prefix, body)

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, made from ``kwargs`` if it
        does not exist (parity: ParameterDict.get)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if k == "shape":
                if v is not None:
                    param.shape = tuple(v) if not isinstance(v, int) \
                        else (v,)
            elif k == "init":
                if v is not None and param.init is None:
                    param.init = v
            elif getattr(param, k, None) is None and v is not None:
                setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError("no constant %s and no value given" % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("duplicate parameter name %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        if init is None:
            init = init_mod.Uniform()
        for p in self._params.values():
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit, generator=generator)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        from ..ndarray import ndarray as _ndm

        arg = {}
        for p in self._params.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p.data()
        _ndm.save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import ndarray as _ndm

        loaded = _ndm.load(filename)
        if not isinstance(loaded, dict):
            raise MXNetError("parameter file %s is not a dict" % filename)
        if restore_prefix:
            loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self._params.items():
            if name not in loaded:
                if not allow_missing:
                    raise MXNetError("parameter %s missing in file %s"
                                     % (name, filename))
                continue
            arr = loaded[name]
            if p._data is None and p._deferred_init is None:
                p.shape = tuple(arr.shape)
                p.initialize(ctx=ctx)
            p.set_data(arr)
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise MXNetError(
                    "file %s has extra parameters %s (pass "
                    "ignore_extra=True)" % (filename, sorted(extra)))
