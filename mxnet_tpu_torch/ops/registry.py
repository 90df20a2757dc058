"""Operator registry and imperative dispatcher.

The port's counterpart of the JAX package's ``ops/registry.py``
(reference: nnvm's ``Op`` registry and ``Imperative::Invoke``).  An op
is an eager PyTorch function ``forward(*tensors, **attrs)`` returning one
tensor or a tuple; nothing here compiles, traces or caches.  ``invoke``
runs it through ``Engine.push`` (the inputs' vars as read vars) on the
inputs' device, which on the card enqueues its kernels on torch's
current stream and returns.

Recording: inside ``autograd.record()`` torch's grad mode is on and a
marked array feeds its leaf view, so torch records the op.  Outside it,
an op whose inputs carry a graph runs under ``torch.no_grad()``: MXNet
records nothing outside ``record()``.  An op with no tensor input
(``_zeros``, ``_arange``, ...) gets the device of its ``ctx`` attr, or
of the current context, as the keyword ``device``.
"""
from __future__ import annotations

import inspect

import torch

from .. import autograd
from ..base import MXNetError
from ..engine import Engine

_REGISTRY = {}
_ALIASES = {}


class OpReg:
    """A registered op: its forward, its tensor inputs (the leading
    parameters without defaults, unless ``inputs=`` names them) and its
    attrs (the other named parameters).  The JAX package's
    ``needs_rng``/``needs_mode`` flags come with the random and
    mode-aware ops (S7, S6); no op of this slice has them."""

    __slots__ = ("name", "forward", "doc", "input_names", "variadic",
                 "attr_names")

    def __init__(self, name, forward, inputs=None):
        self.name = name
        self.forward = forward
        self.doc = forward.__doc__ or ""
        self.input_names, self.variadic = self._infer_inputs(forward, inputs)
        self.attr_names = self._infer_attrs(forward)

    def _infer_attrs(self, fn):
        """Ordered non-tensor parameter names (for positional attr args)."""
        sig = inspect.signature(fn)
        names = [p.name for p in sig.parameters.values()
                 if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                               inspect.Parameter.KEYWORD_ONLY)]
        return tuple(n for n in names if n != "device"
                     and n not in self.input_names)

    def _infer_inputs(self, fn, explicit):
        """Ordered tensor-parameter names: the leading parameters without
        defaults, unless the op declares ``inputs=``."""
        params = list(inspect.signature(fn).parameters.values())
        if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
            return (), True
        if explicit is not None:
            return tuple(explicit), False
        names = []
        for p in params:
            if p.default is not inspect.Parameter.empty:
                break
            names.append(p.name)
        return tuple(names), False


def register(name, aliases=(), inputs=None):
    """Decorator: register a PyTorch forward under an MXNet op name."""

    def deco(fn):
        if name in _REGISTRY:
            raise MXNetError("op %s already registered" % name)
        _REGISTRY[name] = OpReg(name, fn, inputs=inputs)
        for a in aliases:
            _ALIASES[a] = name
        return fn

    return deco


def alias(new, old):
    _ALIASES[new] = old


def get(name):
    reg = _REGISTRY.get(name)
    if reg is None:
        reg = _REGISTRY.get(_ALIASES.get(name, ""))
    if reg is None:
        raise MXNetError("operator %r is not registered" % (name,))
    return reg


def list_ops():
    """Registered op names, primaries and aliases together."""
    return sorted(set(_REGISTRY) | set(_ALIASES))


def _run(reg, datas, attrs, fields):
    if reg.variadic:
        out = reg.forward(*datas, **attrs)
    else:
        out = reg.forward(**dict(zip(fields, datas)), **attrs)
    return out if isinstance(out, tuple) else (out,)


def _prep(reg, n_inputs, attrs, fields):
    """Drop unset attrs, add the device of an op with no tensor input;
    name the input fields."""
    attrs = {k: v for k, v in (attrs or {}).items() if v is not None}
    ctx = None
    if not n_inputs:
        from ..context import as_context

        ctx = as_context(attrs.pop("ctx", None))
        attrs["device"] = ctx.torch_device
    else:
        attrs.pop("ctx", None)
    if fields is None:
        fields = reg.input_names[:n_inputs]
    return attrs, tuple(fields), ctx


def _push(name, fn, datas, read_vars, device):
    """Push ``fn`` and return its output tensors.  Outside ``record()``
    an input that carries a graph must not extend it; an output that is
    an input tensor itself is copied, so each result owns its tensor."""
    eng = Engine.get()
    recording = autograd.is_recording()
    if not recording and any(d.requires_grad for d in datas):
        with torch.no_grad():
            outs = eng.push(fn, read_vars, op_name=name, device=device)
    else:
        outs = eng.push(fn, read_vars, op_name=name, device=device)
    if any(o is d for o in outs for d in datas):
        outs = tuple(o.clone() if any(o is d for d in datas) else o
                     for o in outs)
    if outs and outs[0].is_cuda:
        eng.track(outs[0])
    return outs


def invoke_raw(name, datas, attrs=None, fields=None):
    """Invoke on raw tensors → ``(outputs, None, 0)`` (the JAX package's
    vjp slot is empty: torch's autograd records the op itself)."""
    reg = get(name)
    datas = tuple(datas)
    attrs, fields, _ = _prep(reg, len(datas), attrs, fields)
    outs = _push(name, lambda: _run(reg, datas, attrs, fields), datas, (),
                 datas[0].device if datas else attrs.get("device"))
    return outs, None, 0


def _wrap(outs, inputs, ctx, out):
    from ..ndarray.ndarray import NDArray

    if ctx is None:
        ctx = inputs[0]._ctx
    results = [NDArray._wrap(o, ctx) for o in outs]
    if outs and outs[0].is_cuda:
        # waiting on an output waits on the stream its op went to
        stream = torch.cuda.current_stream(outs[0].device)
        for r in results:
            r._var.stream = stream
    if out is not None:
        outs_list = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs_list, results):
            dst._adopt(src)
        return out
    return results[0] if len(results) == 1 else results


def invoke(name, inputs, attrs=None, out=None, fields=None):
    """Imperative invoke on NDArrays (parity: Imperative::Invoke)."""
    reg = get(name)
    attrs, fields, ctx = _prep(reg, len(inputs), attrs, fields)
    recording = autograd.is_recording()
    datas = tuple(x._op_input(recording) for x in inputs)
    outs = _push(name, lambda: _run(reg, datas, attrs, fields), datas,
                 tuple(x._var for x in inputs),
                 datas[0].device if datas else attrs["device"])
    return _wrap(outs, inputs, ctx, out)


def invoke_fn(fn, inputs, op_name="custom", n_outputs=None, ctx=None):
    """Invoke an ad-hoc ``fn(*tensors) → tuple`` on NDArrays; torch's
    autograd records it inside ``record()`` like any op.  Returns a list
    of NDArrays on ``ctx`` (default: the first input's context)."""
    recording = autograd.is_recording()
    datas = tuple(x._op_input(recording) for x in inputs)
    outs = _push(op_name, lambda: tuple(fn(*datas)), datas,
                 tuple(x._var for x in inputs),
                 datas[0].device if datas else None)
    res = _wrap(outs, inputs, ctx, None)
    return res if isinstance(res, list) else [res]
