"""``mx.operator``: user-defined operators in Python.

The port's counterpart of the JAX package's ``operator.py`` (reference:
``python/mxnet/operator.py``: ``CustomOp``, ``CustomOpProp``,
``register``).  A registered op runs through ``nd.Custom(*inputs,
op_type=...)``: the user's ``forward`` and ``backward`` run on NDArrays,
eagerly, and the op is one ``torch.autograd.Function``, so inside
``autograd.record()`` its backward is the user's ``backward``.  Inside a
hybridized block's call or a captured step the op's Python runs eagerly
within the call, as any other op there: what it launches on the card is
captured with the call, and a host read (``asnumpy``) fails the capture.
"""
from __future__ import annotations

import torch

from . import autograd
from .base import MXNetError

_CUSTOM_REGISTRY = {}


class CustomOp:
    """Base class of a user op (parity: operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as the request says: nothing for
        ``null``, added for ``add``, else overwritten."""
        if req in ("null", 0):
            return
        if req in ("add", 3):
            dst._set_data(dst.data() + src.data())
        else:
            dst._set_data(src.data().to(dst.data().dtype))


class CustomOpProp:
    """An op's metadata and factory (parity: operator.py CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Decorator registering a ``CustomOpProp`` under ``op_type``
    (parity: operator.py register)."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return deco


def get_prop_cls(op_type):
    cls = _CUSTOM_REGISTRY.get(op_type)
    if cls is None:
        raise MXNetError("custom op %r is not registered" % (op_type,))
    return cls


class _Custom(torch.autograd.Function):
    """One user op: ``forward`` on NDArrays over the input tensors into
    fresh output arrays, ``backward`` into fresh zero gradients."""

    @staticmethod
    def forward(ctx, state, *tensors):
        from . import ndarray as nd
        from .ndarray.ndarray import NDArray

        op, is_train, oshapes, otypes, nd_ctx = state
        in_data = [NDArray._wrap(t, nd_ctx) for t in tensors]
        out_data = [nd.empty(tuple(s), dtype=t, ctx=nd_ctx)
                    for s, t in zip(oshapes, otypes)]
        with autograd.pause():
            op.forward(is_train=is_train, req=["write"] * len(out_data),
                       in_data=in_data, out_data=out_data, aux=[])
        outs = tuple(o.data().clone() if any(o.data() is t for t in tensors)
                     else o.data() for o in out_data)
        ctx.state = state
        ctx.in_data, ctx.out_data = in_data, out_data
        return outs

    @staticmethod
    def backward(ctx, *grads):
        from . import ndarray as nd
        from .ndarray.ndarray import NDArray

        op, _, _, _, nd_ctx = ctx.state
        in_grad = [nd.zeros(x.shape, dtype=x.dtype, ctx=nd_ctx)
                   for x in ctx.in_data]
        out_grad = [NDArray._wrap(g.contiguous(), nd_ctx) for g in grads]
        with autograd.pause():
            op.backward(req=["write"] * len(in_grad), out_grad=out_grad,
                        in_data=ctx.in_data, out_data=ctx.out_data,
                        in_grad=in_grad, aux=[])
        return (None,) + tuple(g.data() for g in in_grad)


def custom(*inputs, op_type=None, **kwargs):
    """Run a registered custom op on NDArrays (parity: ``mx.nd.Custom``);
    returns its output, or a list of outputs."""
    from .context import current_context
    from .ndarray.ndarray import NDArray

    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    prop = get_prop_cls(op_type)(**{k: str(v) for k, v in kwargs.items()})
    in_shapes = [tuple(x.shape) for x in inputs]
    ishapes, oshapes, _ = prop.infer_shape(list(in_shapes))
    in_types = [x.dtype for x in inputs]
    _, otypes, _ = prop.infer_type(list(in_types))
    nd_ctx = inputs[0].context if inputs else current_context()
    op = prop.create_operator(nd_ctx, ishapes, in_types)
    recording = autograd.is_recording()
    is_train = autograd.is_training() or recording
    tensors = [x._op_input(recording) for x in inputs]
    state = (op, is_train, oshapes, otypes, nd_ctx)
    if recording:
        outs = _Custom.apply(state, *tensors)
    else:
        with torch.no_grad():
            outs = _Custom.apply(state, *tensors)
    res = [NDArray._wrap(o, nd_ctx) for o in outs]
    return res[0] if len(res) == 1 else res


# surfaced as mx.nd.Custom
Custom = custom
