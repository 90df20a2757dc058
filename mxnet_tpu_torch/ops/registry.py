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

Bulking (``_try_bulk``, the reference's): while ``Engine.bulk_size()``
is positive, an op on NDArrays joins this thread's open
``engine.BulkSegment`` and returns lazy NDArrays; their shapes, dtypes
and grad flags come from one run of the op on the ``meta`` device
(cached per signature).  Ops the reference does not defer flush the
open segment and run eagerly: RNG ops, ops without NDArray inputs, every
op while AMP is on (its dtypes are fixed when it runs), unhashable
attrs, ``out=`` (the port writes it in place) and ops with no meta run
(the reference's ``eval_shape`` failure).
"""
from __future__ import annotations

import functools
import inspect

import torch

from .. import amp as _amp
from .. import autograd
from ..base import MXNetError
from ..engine import Engine

_REGISTRY = {}
_ALIASES = {}
# op name -> fn(inputs, attrs, out): ops whose Python bodies drive other
# ops (control flow) run through these instead of the dispatcher
_OVERRIDES = {}


class OpReg:
    """A registered op: its forward, its tensor inputs (the leading
    parameters without defaults, unless ``inputs=`` names them) and its
    attrs (the other named parameters).  The JAX package's
    ``needs_rng`` flag marks an op that draws random numbers: bulking
    never defers it.  A ``needs_mode`` op (``BatchNorm``, ``Dropout``)
    gets ``_mode="train"`` or ``"predict"`` from
    ``autograd.is_training()`` unless the caller sets it.  An
    ``inplace`` op (the optimizer updates) writes its tensor inputs: it
    is never deferred, and its inputs' versions move."""

    __slots__ = ("name", "forward", "doc", "input_names", "variadic",
                 "attr_names", "needs_rng", "needs_mode", "inplace")

    def __init__(self, name, forward, inputs=None, needs_rng=False,
                 needs_mode=False, inplace=False):
        self.name = name
        self.forward = forward
        self.needs_rng = needs_rng
        self.needs_mode = needs_mode
        self.inplace = inplace
        self.doc = forward.__doc__ or ""
        self.input_names, self.variadic = self._infer_inputs(forward, inputs)
        self.attr_names = self._infer_attrs(forward)

    def _infer_attrs(self, fn):
        """Ordered non-tensor parameter names (for positional attr args)."""
        sig = inspect.signature(fn)
        names = [p.name for p in sig.parameters.values()
                 if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                               inspect.Parameter.KEYWORD_ONLY)]
        return tuple(n for n in names if n not in ("device", "_mode")
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


def register(name, aliases=(), inputs=None, needs_rng=False,
             needs_mode=False, inplace=False):
    """Decorator: register a PyTorch forward under an MXNet op name."""

    def deco(fn):
        if name in _REGISTRY:
            raise MXNetError("op %s already registered" % name)
        _REGISTRY[name] = OpReg(name, fn, inputs=inputs, needs_rng=needs_rng,
                                needs_mode=needs_mode, inplace=inplace)
        for a in aliases:
            _ALIASES[a] = name
        return fn

    return deco


def alias(new, old):
    _ALIASES[new] = old


def register_invoke_override(name, fn):
    """Route ``invoke(name, ...)`` to ``fn(inputs, attrs, out)`` (the JAX
    package's hook of the same name): for ops whose attrs are Python
    callables that run other ops on NDArrays (``_foreach``,
    ``_while_loop``, ``_cond``), ops on sparse arrays, and calls that
    must run eagerly (``Embedding`` with a row-sparse gradient); these
    are never deferred.  An override that returns ``NotImplemented``
    hands the call back to the dispatcher."""
    _OVERRIDES[name] = fn


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
    if reg.needs_mode and "_mode" not in attrs:
        attrs["_mode"] = "train" if autograd.is_training() else "predict"
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


def _push(name, fn, datas, read_vars, device, write_vars=()):
    """Push ``fn`` and return its output tensors.  Outside ``record()``
    an input that carries a graph must not extend it; an output that is
    an input tensor itself is copied, so each result owns its tensor."""
    eng = Engine.get()
    recording = autograd.is_recording()
    if not recording and any(d.requires_grad for d in datas):
        with torch.no_grad():
            outs = eng.push(fn, read_vars, write_vars, op_name=name,
                            device=device)
    else:
        outs = eng.push(fn, read_vars, write_vars, op_name=name,
                        device=device)
    if any(o is d for o in outs for d in datas):
        outs = tuple(o.clone() if any(o is d for d in datas) else o
                     for o in outs)
    if outs and outs[0].is_cuda:
        eng.track(outs[0])
    return outs


def invoke_raw(name, datas, attrs=None, fields=None, push=True):
    """Invoke on raw tensors → ``(outputs, None, 0)`` (the JAX package's
    vjp slot is empty: torch's autograd records the op itself).  With
    ``push=False`` the op runs in the caller's thread, as a Gluon layer
    runs it (``nn.Lambda``), with no engine push."""
    reg = get(name)
    datas = tuple(datas)
    attrs, fields, _ = _prep(reg, len(datas), attrs, fields)
    if not push:
        return _run(reg, datas, attrs, fields), None, 0
    outs = _push(name, lambda: _run(reg, datas, attrs, fields), datas, (),
                 datas[0].device if datas else attrs.get("device"))
    return outs, None, 0


def _wrap(outs, inputs, ctx, out):
    from ..ndarray.ndarray import NDArray

    if ctx is None:
        ctx = inputs[0]._ctx
    # results take the class of the first input (``mx.np.ndarray`` stays
    # ``mx.np.ndarray``), as the JAX package's ``_op_result_cls`` does
    cls = inputs[0]._op_result_cls if inputs else NDArray
    results = [cls._wrap(o, ctx) for o in outs]
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


def _freeze(x):
    """A hashable mirror of an attr value (lists and dicts frozen)."""
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


@functools.lru_cache(maxsize=4096)
def _out_meta(name, fields, attrs_key, in_meta, recording, attrs_ref):
    """``((shape, dtype, requires_grad), ...)`` of the op's outputs from
    one run on the ``meta`` device, or None where it has no meta run."""
    reg = get(name)
    args = [torch.empty(shape, dtype=dt, device="meta").requires_grad_(
        rg and (dt.is_floating_point or dt.is_complex))
        for shape, dt, rg in in_meta]
    try:
        with torch.set_grad_enabled(recording):
            outs = _run(reg, args, attrs_ref.attrs, fields)
        return tuple((tuple(o.shape), o.dtype, o.requires_grad)
                     for o in outs)
    except Exception:
        return None


class _Attrs:
    """Attrs beside their frozen key: hashed and compared by the key, so
    the meta cache keeps one run per signature."""

    __slots__ = ("attrs", "key")

    def __init__(self, attrs, key):
        self.attrs, self.key = attrs, key

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return self.key == other.key


def _try_bulk(reg, inputs, attrs, out, fields, eng):
    """Defer one op into this thread's open bulk segment.

    Returns the op's lazy NDArray results, or ``NotImplemented`` to run
    it eagerly.  Non-deferrable ops flush the open segment first so that
    program order holds."""
    from ..ndarray.ndarray import NDArray

    size = eng.bulk_size()
    if size <= 0:
        return NotImplemented
    if reg.needs_rng:
        eng.flush_bulk("rng:%s" % reg.name)
        return NotImplemented
    if reg.inplace:
        eng.flush_bulk("inplace:%s" % reg.name)
        return NotImplemented
    if out is not None or not inputs \
            or any(not isinstance(x, NDArray) for x in inputs):
        eng.flush_bulk("nondeferrable:%s" % reg.name)
        return NotImplemented
    if _amp.is_active():
        # an op's dtypes under AMP are fixed when it runs: never deferred
        eng.flush_bulk("amp:%s" % reg.name)
        return NotImplemented
    attrs, fields, _ = _prep(reg, len(inputs), attrs, fields)
    try:
        attrs_key = _freeze(attrs)
        hash(attrs_key)
    except TypeError:
        eng.flush_bulk("unhashable_attrs:%s" % reg.name)
        return NotImplemented
    recording = autograd.is_recording()
    device = None
    for x in inputs:
        x._var.rethrow()
        p = x._pending
        dev = p.device if p is not None else x._value.device
        if device is None:
            device = dev
        elif dev != device:
            return NotImplemented       # the eager op raises
    seg = eng.current_segment(size, device)
    handles, in_meta = [], []
    for x in inputs:
        p = x._pending
        if p is not None and p.segment is seg and p.value is None \
                and not p.failed:
            handles.append(("v", p))
            in_meta.append((p.shape, p.dtype, p.requires_grad))
        else:
            d = x._op_input(recording)
            handles.append(("x", d, x._stable))
            in_meta.append((tuple(d.shape), d.dtype, d.requires_grad))
    metas = _out_meta(reg.name, fields, attrs_key, tuple(in_meta),
                      recording, _Attrs(attrs, attrs_key))
    if metas is None:
        return NotImplemented           # no meta run: eagerly
    run_fn = (lambda r, a, f: lambda *datas: _run(r, datas, a, f))(
        reg, attrs, fields)
    refs = seg.defer((reg.name, fields, attrs_key), run_fn, handles, metas,
                     recording)
    eng.stats.bulk_ops += 1
    ctx = inputs[0]._ctx
    results = [inputs[0]._op_result_cls._lazy(r, ctx) for r in refs]
    # a failed flush poisons every promised output (async rethrow)
    seg.write_vars.extend(a._var for a in results)
    if seg.cap and seg.n_ops >= seg.cap:
        seg.flush("max_node")
    return results[0] if len(results) == 1 else results


def invoke(name, inputs, attrs=None, out=None, fields=None):
    """Imperative invoke on NDArrays (parity: Imperative::Invoke); a
    deferrable op joins the open bulk segment (``_try_bulk``)."""
    reg = get(name)
    eng = Engine.get()
    override = _OVERRIDES.get(reg.name)
    if override is not None:
        res = override(list(inputs), dict(attrs or {}), out)
        if res is not NotImplemented:
            return res
    res = _try_bulk(reg, inputs, attrs, out, fields, eng)
    if res is not NotImplemented:
        return res
    attrs, fields, ctx = _prep(reg, len(inputs), attrs, fields)
    recording = autograd.is_recording()
    datas = tuple(x._op_input(recording) for x in inputs)
    reads = tuple(x._var for x in inputs)
    outs = _push(name, lambda: _run(reg, datas, attrs, fields), datas,
                 reads, datas[0].device if datas else attrs["device"],
                 reads if reg.inplace else ())
    return _wrap(outs, inputs, ctx, out)


def invoke_fn(fn, inputs, op_name="custom", n_outputs=None, ctx=None):
    """Invoke an ad-hoc ``fn(*tensors) → tuple`` on NDArrays; torch's
    autograd records it inside ``record()`` like any op.  Returns a list
    of NDArrays on ``ctx`` (default: the first input's context).  It is
    never deferred: the open bulk segment flushes first."""
    Engine.get().flush_bulk("nondeferrable:%s" % op_name)
    recording = autograd.is_recording()
    datas = tuple(x._op_input(recording) for x in inputs)
    outs = _push(op_name, lambda: tuple(fn(*datas)), datas,
                 tuple(x._var for x in inputs),
                 datas[0].device if datas else None)
    res = _wrap(outs, inputs, ctx, None)
    return res if isinstance(res, list) else [res]
