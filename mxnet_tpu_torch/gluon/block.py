"""Blocks: ``Block`` and ``HybridBlock`` as ``torch.nn.Module``s.

The port's counterpart of ``mxnet_tpu/gluon/block.py``.  A block is a
module whose ``forward`` is plain torch, or a ``HybridBlock`` that
defines ``hybrid_forward(self, F, x, *args, **params)`` and no
``forward``: it is called as the JAX package calls it, with ``F`` the
port's ``ndarray`` module (``F.contrib`` among its names), the inputs
and the block's own registered parameters (by their attribute names) as
NDArrays over the same tensors, and its outputs handed back in the form
the inputs came in (tensors for tensors, NDArrays for NDArrays).  Its
parameters are ``gluon.Parameter`` handles (``parameter.py``) over the
tensors the module registers: assigning a handle as an attribute, or
``self.params.get(...)``'s handle, registers its tensor under the
attribute name, and a tensor registered the torch way gets a handle
too.  So a block has both of the JAX package's namings:

* ``collect_params(select=None)`` is a ``ParameterDict`` of the handles
  under their prefixed names (``bertmodel0_word_weight``), made as the
  JAX package makes them: each block's prefix comes from its
  ``name_scope()`` parent's counters, or from the process-wide counter
  of its class's lower-cased name (``_name_manager_next``);
* ``_collect_params_with_prefix()`` is ``{structural name: tensor}``
  (``word_embed.weight``), which equals ``state_dict()``'s keys.

Sharing goes through ``params=``: a block given another's
``collect_params()`` gets its handles, and so registers the same
tensors.  ``save_parameters``/``load_parameters`` write and read the
JAX package's ``.params`` files under the structural names (f32 for a
bf16 tensor; a channels-last convolution's weight as HWIO, as the JAX
package keeps it), with its fallbacks on load: ``arg:``/``aux:`` keys,
the prefixed names, and the prefixed names with the instance prefix
taken off.

A block called with NDArrays runs on their tensors (a lazy array is
flushed first; inside ``autograd.record()`` a marked array feeds its
leaf view) and returns NDArrays on the first input's context, of the
first input's class (``mx.np.ndarray`` in, ``mx.np.ndarray`` out), so
an NDArray loss's ``backward()`` fills the parameters' gradients.  Tensor
inputs give tensor outputs.  The port's own layers run on the tensors;
a ``forward`` written outside this package gets, in a call with
NDArrays, NDArrays over those tensors (as the JAX package hands
``forward`` what the caller passed), its ops run eagerly and recorded
as ``hybrid_forward``'s are, and its NDArray outputs go back as their
tensors; called with tensors, it gets tensors.  Only the outermost
user ``forward`` of a call converts: one it reaches through ``super()``
gets what it is passed and returns what it makes (NDArrays stay
NDArrays), and a ``forward`` of the port's own that it reaches so gets
the tensors and gives NDArrays back.  Forward hooks and pre-hooks
(``register_forward_hook``: MXNet's ``hook(block, inputs, outputs)``)
run around each call with what the caller passed and got.

Gradients follow the parameter's ``grad_req``.  ``"write"``, the
default: each ``backward()`` overwrites a parameter's ``.grad``
(contributions within one backward, as a tied weight's, are summed),
where torch would add to it.  When the outermost block call of a
thread returns with grad mode on, :func:`write_grads` arms each of the
tree's parameters: a pre-hook on the ``AccumulateGrad`` node the call's
graph holds for it drops the old ``.grad`` (unless the tensor's
``_grad_req`` is ``"add"``, read when the hook runs) and marks the new
one fresh (``p._fresh_grad``; ``gluon.Trainer`` reads and clears the
mark).  ``"null"`` turns ``requires_grad`` off.  The node runs only
when torch accumulates into ``.grad``, so ``torch.autograd.grad``
(``JitTrainStep``, the graph pair's captured backward) never triggers
it, and the engine sums a leaf's inputs before it calls the node, so it
runs once a backward.  The nodes are not kept beyond torch's own
lifetime: a node records the stream it was made on, and one held from
an eager call into a CUDA graph capture on another stream would make
the capture fail.  A tensor that no block owns is armed when a
backward reaches it (:func:`write_grads_when_reached`, a hook on the
tensor that holds no node).  ``JitTrainStep`` runs its net under
:func:`grads_unwritten`, since it never writes ``.grad``.

``HybridBlock.hybridize()`` is the counterpart of the JAX package's one
compiled executable per input signature: on the card, the outermost
hybridized block runs each signature as one captured CUDA graph
(``graph_cache.CapturedCall``), and the blocks it calls are captured
with it.  A call that autograd records runs as a forward graph and a
backward graph (``graph_cache.RecordedCall``), the counterpart of the
reference's cached jitted vjp.  ``hybridize(aot=path)`` keeps the
unrecorded signatures in a bundle (``compile_cache``) that a fresh
process captures ahead of its first call, the counterpart of the
reference's AOT warm start.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import threading
import warnings
import weakref
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd as _autograd
from .. import compile_cache as _ccache
from .. import engine as _engine
from .. import graph_cache as _graph_cache
from .. import initializer as _init
from ..base import MXNetError
from ..context import Context
from ..ndarray.ndarray import NDArray
from .parameter import (Parameter, ParameterDict,  # noqa: F401
                        DeferredInitializationError, as_dtype)
from .utils import HookHandle

# how deep this thread is inside a hybridized block's call: the blocks
# it calls run eagerly and are captured with it (the reference's
# is_tracing())
_nesting = threading.local()
# how deep this thread is inside block calls, and whether the outermost
# call arms its parameters (write_grads) when it returns
_calls = threading.local()

_LAZY = torch.nn.parameter.UninitializedTensorMixin


def _overwrite(ref, grad_outputs):
    p = ref()
    if p is not None:
        if getattr(p, "_grad_req", "write") != "add":
            p.grad = None
        p._fresh_grad = True


def write_grads(params):
    """Arm each tensor of ``params`` that takes a gradient for its
    ``grad_req`` (see the module docstring): a pre-hook on the
    ``AccumulateGrad`` node its graph holds for it, once a node.  No
    node is held here: one that no graph holds is freed on return.  The
    node is found through a view, as ``torch.autograd.graph.
    get_gradient_edge`` finds it, without that function's own checks
    (which cost as much again per parameter)."""
    with torch.enable_grad():
        for p in params:
            if not p.requires_grad or not p.is_leaf or isinstance(p, _LAZY):
                continue
            node = p.view_as(p).grad_fn.next_functions[0][0]
            if not node.metadata.get("write_grads"):
                node.register_prehook(
                    functools.partial(_overwrite, weakref.ref(p)))
                node.metadata["write_grads"] = True


def _arm_reached(ref, grad):
    p = ref()
    if p is not None:
        write_grads((p,))


def write_grads_when_reached(tensor):
    """Arm a tensor that no block call arms (``gluon.Trainer``'s raw
    tensors): a hook on the tensor, which torch runs when a backward
    reaches it, arms the node of that backward before the node runs.
    The hook holds no node; under ``torch.autograd.grad`` the node it
    arms never runs.  Once a tensor."""
    if tensor.requires_grad and tensor.is_leaf \
            and not getattr(tensor, "_write_when_reached", False):
        tensor.register_hook(
            functools.partial(_arm_reached, weakref.ref(tensor)))
        tensor._write_when_reached = True


@contextlib.contextmanager
def grads_unwritten():
    """Block calls in this thread arm nothing (``JitTrainStep``: its
    gradients come from ``torch.autograd.grad``)."""
    saved = getattr(_calls, "quiet", False)
    _calls.quiet = True
    try:
        yield
    finally:
        _calls.quiet = saved


@contextlib.contextmanager
def calls_inline():
    """Hybridized blocks called in this thread run eagerly, as blocks
    called inside a hybridized block's call do: for a step that is
    captured whole (``JitTrainStep``), whose capture must not replay a
    block's own graphs (the reference's blocks run imperatively inside
    its step's trace)."""
    _nesting.depth = getattr(_nesting, "depth", 0) + 1
    try:
        yield
    finally:
        _nesting.depth -= 1


class _BlockScope:
    """Name manager for nested blocks (parity: block.py _BlockScope): a
    block made inside ``parent.name_scope()`` takes its prefix from the
    parent's prefix and the parent's count of its hint."""

    _current = threading.local()

    def __init__(self, block):
        # a weak reference: a block and its scope would otherwise form a
        # cycle, and a model's memory would wait for the cyclic collector
        self._block_ref = weakref.ref(block)
        self._counter = {}
        self._old_scope = None

    @property
    def _block(self):
        return self._block_ref()

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_manager_next(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *a):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


_name_counter = {}
_name_lock = threading.Lock()


def _name_manager_next(hint):
    """The process-wide name of the next block of ``hint`` made outside
    any ``name_scope()`` (``dense0``, ``dense1``, ...)."""
    with _name_lock:
        c = _name_counter.get(hint, 0)
        _name_counter[hint] = c + 1
    return "%s%d" % (hint, c)


def _nd_first(args):
    """The first NDArray among ``args``, else None: its context and its
    class (``mx.np.ndarray`` or NDArray) are the call's outputs'."""
    for a in args:
        if isinstance(a, NDArray):
            return a
    return None


@contextlib.contextmanager
def _call_class(cls):
    """The class that ``_nd_in`` wraps tensors in for the scope: the
    class of the NDArrays a call was made with."""
    prev = getattr(_calls, "cls", NDArray)
    _calls.cls = cls
    try:
        yield
    finally:
        _calls.cls = prev


def _user_forward(forward):
    """``forward`` of a block class written outside this package, run on
    NDArrays when it is the outermost user ``forward`` of a call made
    with NDArrays (see the module docstring); otherwise as it is."""
    @functools.wraps(forward)
    def nd_forward(self, *args, **kwargs):
        if id(self) not in getattr(_calls, "nd", ()):
            return forward(self, *args, **kwargs)
        with _nd_mark(self, False), _engine.unbulked(), \
                _autograd._RecordingStateScope(torch.is_grad_enabled(),
                                               None):
            out = forward(self, *_nd_in(args), **kwargs)
        return _tensors_out(out)

    return nd_forward


def _port_forward(forward):
    """``forward`` of one of the port's block classes, reached through
    ``super()`` from a user's ``forward``: NDArray arguments go in as
    their tensors and the outputs come back as NDArrays."""
    @functools.wraps(forward)
    def tensor_forward(self, *args, **kwargs):
        first = _nd_first(args)
        if first is None:
            return forward(self, *args, **kwargs)
        out = forward(self, *(_tensor_arg(a, _autograd.is_recording())
                              for a in args), **kwargs)
        return _nd_out(out, first.context, first._op_result_cls)

    tensor_forward._mx_port = True
    return tensor_forward


def _is_port_class(cls):
    return cls.__module__.startswith(__name__.split(".")[0] + ".")


@contextlib.contextmanager
def _nd_mark(block, on):
    """Mark (``on``) or clear, for the scope, that ``block``'s call on
    this thread was made with NDArrays and its outermost user
    ``forward`` has yet to take them (``_user_forward``)."""
    calls = _calls.__dict__.setdefault("nd", set())
    key = id(block)
    was = key in calls
    if on:
        calls.add(key)
    else:
        calls.discard(key)
    try:
        yield
    finally:
        if was:
            calls.add(key)
        else:
            calls.discard(key)


def _tensor_arg(a, recording):
    """What a block's forward reads for ``a``: an NDArray's tensor (a
    lazy array flushed; a marked one's leaf view inside ``record()``)."""
    return a._op_input(recording) if isinstance(a, NDArray) else a


def _nd_out(out, ctx, cls=NDArray):
    """A block's tensor outputs as arrays of ``cls`` on ``ctx``."""
    if isinstance(out, torch.Tensor):
        return cls._wrap(out, ctx)
    if isinstance(out, (tuple, list)):
        return type(out)(_nd_out(o, ctx, cls) for o in out)
    return out


class Block(torch.nn.Module):
    """Base block (parity: gluon.Block)."""

    _nd_forward = False     # forward written outside this package
    # a recorded call gives a parameter a row-sparse gradient
    # (Embedding(sparse_grad=True)); a hybridized tree holding such a
    # block runs its recorded calls eagerly
    _sparse_grad = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        forward = cls.__dict__.get("forward")
        if forward is None or _is_port_class(cls):
            return
        cls.forward = _user_forward(forward)
        cls._nd_forward = True
        # the port's forwards this one can reach through super()
        for base in cls.__mro__[1:]:
            own = base.__dict__.get("forward")
            if (own is not None and issubclass(base, Block)
                    and _is_port_class(base)
                    and not getattr(own, "_mx_port", False)):
                base.forward = _port_forward(own)

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = OrderedDict()   # attribute -> Parameter
        self._mx_pre_hooks = OrderedDict()
        self._mx_hooks = OrderedDict()
        self._params_seen = None      # (tree generation, parameters)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """Blocks made in this scope take their prefixes from this
        block (parity: Block.name_scope)."""
        return self._scope

    @property
    def params(self):
        """This block's own ``ParameterDict`` (its children's are not in
        it: ``collect_params()`` gathers the tree)."""
        return self._params

    # -- registration ---------------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._register_handle(name, value)
            return
        super().__setattr__(name, value)

    def _register_handle(self, name, param, buffer=False):
        """Register ``param``'s tensor (made now if need be) under
        ``name``: as a parameter, or as a buffer (running statistics)."""
        if buffer:
            param._buffer = True
            param._grad_req = "null"
        t = param._ensure_tensor()
        self.__dict__["_reg_params"][name] = param
        if buffer:
            torch.nn.Module.register_buffer(self, name, t)
        else:
            torch.nn.Module.register_parameter(self, name, t)
            t._block_owned = True     # armed by its block's calls

    def register_parameter(self, name, param):
        """Register a tensor the torch way; it gets a handle named by
        this block's prefix (or takes the one registered before under
        ``name``)."""
        super().register_parameter(name, param)
        if param is None:
            return
        param._block_owned = True
        reg = self.__dict__.get("_reg_params")
        if reg is None:
            return
        handle = reg.get(name)
        if handle is None:
            handle = self._params.get(
                name, grad_req="write" if param.requires_grad else "null",
                shape=None if isinstance(param, _LAZY)
                else tuple(param.shape),
                dtype=param.dtype, init=getattr(param, "init", None))
            reg[name] = handle
        if handle._tensor is not param:
            init = getattr(param, "init", handle.init)
            handle._attach(param)
            handle.init = init

    def register_child(self, block, name=None):
        """Add ``block`` as a child (parity: Block.register_child)."""
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)

    def _tree_params(self):
        """The tree's parameters, collected again only after a module,
        parameter or buffer was registered or converted somewhere."""
        gen = _graph_cache.tree_generation()
        if self._params_seen is None or self._params_seen[0] != gen:
            self._params_seen = (gen, list(self.parameters()))
        return self._params_seen[1]

    def _blocks(self):
        return [c for c in self._modules.values() if isinstance(c, Block)]

    def collect_params(self, select=None):
        """The tree's ``Parameter``s under their prefixed names, each
        block's own and then its children's in order, those whose name
        matches the regular expression ``select`` if one is given
        (parity: Block.collect_params).  Running statistics are listed
        with ``grad_req="null"``."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._blocks():
            ret.update(child.collect_params(select=select))
        return ret

    def _param_handles(self, prefix=""):
        """``{structural name: Parameter}``."""
        if prefix:
            prefix += "."
        ret = {prefix + name: p for name, p in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._param_handles(prefix + name))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """``{structural name: tensor}`` (``encoder.layers.0.ln1.gamma``),
        parameters and running statistics, as ``state_dict()`` names
        them."""
        return {k: p._tensor
                for k, p in self._param_handles(prefix).items()}

    # -- hooks ----------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        """``hook(block, inputs)`` before each call (parity:
        Block.register_forward_pre_hook); returns a ``HookHandle``."""
        handle = HookHandle()
        handle.attach(self._mx_pre_hooks, hook)
        return handle

    def register_forward_hook(self, hook):
        """``hook(block, inputs, outputs)`` after each call (parity:
        Block.register_forward_hook); returns a ``HookHandle``."""
        handle = HookHandle()
        handle.attach(self._mx_hooks, hook)
        return handle

    def apply(self, fn):
        """``fn(block)`` on every child, depth first, then on this block
        (parity: Block.apply)."""
        for child in self._blocks():
            child.apply(fn)
        fn(self)
        return self

    # -- calls ----------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        for hook in tuple(self._mx_pre_hooks.values()):
            hook(self, args)
        first = _nd_first(args)
        if first is None:
            out = self._outermost(*args, **kwargs)
        else:
            targs = tuple(_tensor_arg(a, _autograd.is_recording())
                          for a in args)
            cls = first._op_result_cls
            with _call_class(cls), (_nd_mark(self, True) if self._nd_forward
                                    else contextlib.nullcontext()):
                out = self._outermost(*targs, **kwargs)
            out = _nd_out(out, first.context, cls)
        for hook in tuple(self._mx_hooks.values()):
            hook(self, args, out)
        return out

    def _outermost(self, *args, **kwargs):
        if getattr(_calls, "depth", 0):
            return self._call(*args, **kwargs)
        _calls.depth = 1
        try:
            out = self._call(*args, **kwargs)
        finally:
            _calls.depth = 0
        if torch.is_grad_enabled() and not getattr(_calls, "quiet", False):
            write_grads(self._tree_params())
        return out

    def _call(self, *args, **kwargs):
        return torch.nn.Module.__call__(self, *args, **kwargs)

    # -- initialization and dtypes ------------------------------------------
    def initialize(self, init=None, device=None, verbose=False,
                   force_reinit=False, generator=None, ctx=None):
        """Fill every parameter from its own ``init``, else from ``init``
        (default ``Uniform()``), drawing from ``generator``.  A parameter
        initialized before is left alone unless ``force_reinit``.
        Parameters whose shape is known only at the first forward
        (``Dense(in_units=0)``) are filled then.  ``device`` (or ``ctx``)
        is accepted for parity: parameters live where their block was
        built."""
        del verbose
        default = _init.create(init)
        seen = set()
        for p in self.collect_params().values():
            if id(p) not in seen:
                seen.add(id(p))
                p.initialize(None, device if device is not None else ctx,
                             default_init=default, force_reinit=force_reinit,
                             generator=generator)
        if force_reinit:
            _clear_caches(self)
        return self

    def _finish_param(self, name, shape):
        """Give the deferred parameter ``name`` its shape and fill it."""
        p = self._reg_params[name]
        if p._deferred_init is None:
            raise MXNetError("%s: call initialize() before the first "
                             "forward" % type(self).__name__)
        p.shape = shape
        p._finish_deferred_init()

    def cast(self, dtype):
        """Cast every floating-point parameter of this block and, through
        their own ``cast``, of its children to ``dtype`` (parity:
        Block.cast, which ``amp.convert_hybrid_block`` uses;
        ``nn.BatchNorm`` keeps f32 under bf16 and f16)."""
        _clear_caches(self)
        for child in self.children():
            if isinstance(child, Block):
                child.cast(dtype)
            else:
                cast_tensors(child.parameters(), as_dtype(dtype))
        cast_tensors(self._parameters.values(), as_dtype(dtype))
        return self

    def _apply(self, fn, *args, **kwargs):
        # ``to()``, ``float()`` and the like may put new tensors in the
        # tree's dicts without registering them: each handle follows its
        # name to the tensor there now (a buffer is always a new one)
        out = super()._apply(fn, *args, **kwargs)
        for name, handle in self._reg_params.items():
            t = self._buffers.get(name, self._parameters.get(name))
            if t is not None and handle._tensor is not t:
                t._initialized = getattr(handle._tensor, "_initialized",
                                         False)
                handle._attach(t)
        _graph_cache.tree_changed()
        return out

    def hybridize(self, active=True, **kwargs):
        """Arm (or, with ``active=False``, disarm) every
        ``HybridBlock`` below this one (parity: Block.hybridize, which
        recurses)."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)
        return self

    def zero_grad(self):
        """Zero every parameter's gradient in place (parity:
        Block.zero_grad; torch's ``Module.zero_grad`` would drop them)."""
        for p in self.collect_params().values():
            p.zero_grad()

    # -- .params files ----------------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Write the parameters and running statistics as a ``.params``
        file under their structural names (parity:
        Block.save_parameters): bf16 as f32, a channels-last
        convolution's weight as HWIO.  ``deduplicate`` writes a tensor
        shared by several blocks once, under its first name.  The write
        is atomic."""
        from ..ndarray import ndarray as _ndm

        out, seen = {}, set()
        for name, p in self._param_handles().items():
            if deduplicate and id(p) in seen:
                continue
            seen.add(id(p))
            p._check_initialized()
            out[name] = p._file_array()
        _ndm.save_arrays(filename, out)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Read a ``.params`` file into the parameters, in place and in
        each one's dtype (parity: Block.load_parameters, with its
        fallbacks: ``arg:``/``aux:`` keys, the prefixed names, and the
        prefixed names without the instance prefix).  A deferred
        parameter takes its shape from the file.  ``ctx`` and
        ``cast_dtype`` are accepted for parity."""
        from ..ndarray import ndarray as _ndm

        loaded = _ndm.load_arrays(filename)
        if not isinstance(loaded, dict):
            raise MXNetError("%s is not a parameter dict file" % filename)
        if any(k.startswith(("arg:", "aux:")) for k in loaded):
            loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                      else k: v for k, v in loaded.items()}
        params = self._param_handles()
        if loaded and not set(loaded) & set(params):
            by_flat = {p.name: p for p in self.collect_params().values()}
            if set(loaded) & set(by_flat):
                params = by_flat
            else:
                def strip(k):
                    return k.split("_", 1)[1] if "_" in k else k

                flat2 = {}
                for p in self.collect_params().values():
                    flat2.setdefault(strip(p.name), p)
                loaded2 = {}
                for k, v in loaded.items():
                    loaded2.setdefault(strip(k), v)
                if len(flat2) == len(by_flat) and \
                        len(loaded2) == len(loaded) and \
                        set(loaded2) & set(flat2):
                    params, loaded = flat2, loaded2
        for name, p in params.items():
            if name not in loaded:
                if not allow_missing:
                    raise MXNetError("parameter %s missing in %s"
                                     % (name, filename))
                continue
            p._set_file_array(loaded[name])
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError("%s has extra parameters %s"
                                 % (filename, sorted(extra)))

    # -- summary and shapes ------------------------------------------------------
    def summary(self, *inputs):
        """Print each block's output shape and parameter count from one
        forward of ``inputs`` (parity: Block.summary)."""
        rows, handles = [], []

        def make_hook(name):
            def hook(block, ins, outs):
                out = outs[0] if isinstance(outs, (list, tuple)) else outs
                n_params = sum(
                    int(np.prod(p.shape)) for p in block._reg_params.values()
                    if p._data is not None)
                rows.append((name or "(root)", block.__class__.__name__,
                             tuple(out.shape), n_params))
            return hook

        for name, child in self._iter_blocks():
            handles.append(child.register_forward_hook(make_hook(name)))
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.detach()
        header = "%-30s %-20s %-20s %10s" % ("Layer", "Type",
                                             "Output Shape", "Params")
        lines = [header, "-" * len(header)]
        total = 0
        for name, typ, shape, n in rows:
            lines.append("%-30s %-20s %-20s %10d" % (name, typ, shape, n))
            total += n
        lines.append("-" * len(header))
        lines.append("Total params: %d" % total)
        print("\n".join(lines))

    def _iter_blocks(self, prefix=""):
        yield prefix, self
        for name, child in self._modules.items():
            if isinstance(child, Block):
                yield from child._iter_blocks(
                    prefix + ("." if prefix else "") + name)


class HybridBlock(Block):
    """A block whose calls run as captured CUDA graphs once
    ``hybridize()``d (parity: gluon.HybridBlock).

    Each call is keyed by its tensor inputs' ``(shape, dtype, device)``
    and ``autograd.is_training()``.  Per key, the first call runs
    eagerly, the second captures one CUDA graph and replays it, later
    calls replay; outputs are handed back as fresh tensors.  A call that
    autograd records (grad mode on and a parameter or input requiring
    grad) is keyed also by which inputs and parameters require grad, and
    replays a forward graph whose outputs carry a backward graph that
    gives their gradients; while that backward is pending, a call of
    the same key runs eagerly (``stats()["busy_calls"]``).  A recorded
    call of a tree that holds an ``Embedding(sparse_grad=True)`` runs
    eagerly (``stats()["sparse_calls"]``): its row-sparse gradient's row
    count depends on the data, so it cannot be captured.  The graphs
    read the parameters in place, so an in-place update shows in the
    next replay; a parameter whose storage moved is captured again, and
    ``hybridize(False)``, ``clear_cache()``, ``cast()`` and
    ``initialize(force_reinit=True)`` drop the graphs.  Calls inside a
    hybridized block's call, calls with keyword arguments or without a
    tensor input, and calls on the CPU run eagerly.
    """

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._graphs = _graph_cache.CallCache()     # signature -> call
        self._watched = None    # (tree generation, parameters + buffers)
        self._aot_path = None       # hybridize(aot=...) bundle file
        self._aot_entries = None    # its entries, read once
        self._aot_pending = False   # its signatures not captured yet
        self._sparse_calls = 0      # recorded calls run eagerly (sparse)

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  lint=False, aot=None, **kwargs):
        """Arm or disarm graph capture (parity: HybridBlock.hybridize).
        ``static_alloc`` and ``static_shape`` are accepted for parity: a
        graph's buffers are static by construction.  ``lint=True`` (the
        mxlint passes) is not ported and raises.

        ``aot=path`` keeps the block's call signatures in a bundle
        (``compile_cache.save_bundle``): each unrecorded signature is
        written at its first call, with the parameters' names, the
        auxiliary ones (running statistics) and the number of outputs.
        A block armed with an existing bundle captures each saved
        signature ahead of its first call, once its parameters are
        initialized (here, or at the first call), so that call is a
        replay; the parameters the bundle names must be this block's
        (else ``MXNetError`` naming both lists).  A bundle that cannot
        be read warns, is counted (``aot_unusable``) and the block
        captures live.  Recorded calls are not saved: they run as
        before.  On the CPU nothing is captured; the entries are written
        and checked all the same."""
        if active and lint:
            raise MXNetError("hybridize(lint=True) is not ported yet: the "
                             "mxlint passes come with slice S9 (ROADMAP.md)")
        self._active = bool(active)
        self._aot_path = aot if active else None
        if not active:
            self.clear_cache()
        self._aot_entries = None
        self._aot_pending = self._aot_path is not None
        out = super().hybridize(active, static_alloc=static_alloc,
                                static_shape=static_shape, **kwargs)
        self._aot_prepare()
        return out

    def infer_shape(self, *args):
        """Give the deferred parameters of this block their shapes from
        example inputs (parity: HybridBlock.infer_shape); they are filled
        at the first forward.  Layers with deferred shapes override
        ``_shape_hint``."""
        self._shape_hint(*args)

    def _shape_hint(self, *args):
        return None

    def clear_cache(self):
        """Drop every captured graph of this block (a bundle's signatures
        are captured again at the next call)."""
        self._graphs.clear()
        self._watched = None
        self._aot_pending = self._aot_path is not None

    # -- saved signatures (hybridize(aot=path)) -----------------------------
    def _aot_bundle(self):
        """The bundle's entries, read once; an unusable bundle warns, is
        counted, and gives none."""
        if self._aot_entries is None:
            self._aot_entries = {}
            if os.path.exists(self._aot_path):
                try:
                    doc = _ccache.load_bundle(self._aot_path)
                    self._aot_entries = dict(doc["entries"])
                except MXNetError as e:
                    _ccache.count_unusable()
                    warnings.warn("hybridize(aot=%r): ignoring an unusable "
                                  "bundle (%s); capturing live"
                                  % (self._aot_path, e))
        return self._aot_entries

    def _aot_names(self):
        params = list(self.collect_params().values())
        return ([p.name for p in params],
                [p.name for p in params if getattr(p, "_buffer", False)])

    def _aot_prepare(self):
        """Capture each signature of the bundle ahead of its first call,
        once every parameter has its shape."""
        if not self._aot_pending or any(
                isinstance(t, _LAZY) for t in self._graph_tensors()):
            return
        self._aot_pending = False
        names, _ = self._aot_names()
        captured = 0
        for entry in self._aot_bundle().values():
            if entry["param_names"] != names:
                raise MXNetError(
                    "hybridize(aot=%r): the bundle entry was saved with "
                    "parameters %s but this block has %s: the architecture "
                    "changed since it was saved"
                    % (self._aot_path, entry["param_names"], names))
            wire = entry["signature"]
            key = _graph_cache.signature_from_wire(wire)
            args = _graph_cache.scratch_args(wire)
            device = next(a.device for a in args
                          if isinstance(a, torch.Tensor))
            cc = self._graphs.get(key, self._nested_call, device,
                                  self._graph_tensors, type(self).__name__)
            mode = _autograd.train_mode if key[1] \
                else _autograd.predict_mode
            with torch.no_grad(), mode():
                captured += cc.prepare(
                    args, restore=list(self.buffers()) if key[1] else ())
        _ccache.count_aot_loads(captured)

    def _aot_export(self, key, out):
        """Write ``key``'s entry into the bundle, unless it is there."""
        wire = _graph_cache.signature_to_wire(key)
        if wire is None:
            warnings.warn("hybridize(aot=%r): a call with arguments that "
                          "are neither tensors nor plain values is not "
                          "saved" % self._aot_path)
            return
        entries = self._aot_bundle()
        name = json.dumps(wire, sort_keys=True)
        if name in entries:
            return
        names, aux = self._aot_names()
        entries[name] = {"signature": wire, "param_names": names,
                         "aux_names": aux,
                         "n_outputs": len(_graph_cache._tensors(out))}
        _ccache.save_bundle(self._aot_path, entries,
                            meta={"block": self.name})

    def _call(self, *args, **kwargs):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not self._active or kwargs or not tensors \
                or getattr(_nesting, "depth", 0):
            return super()._call(*args, **kwargs)
        if self._aot_pending:
            self._aot_prepare()
        key = _graph_cache.signature(args, _autograd.is_training())
        watched = self._graph_tensors()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in tensors + watched):
            if _autograd.is_recording() and self._sparse_grads():
                self._sparse_calls += 1
                return super()._call(*args, **kwargs)
            if not self._graphs.pairs_on(tensors[0].device):
                return super()._call(*args, **kwargs)
            key += (_graph_cache.grad_signature(tensors),
                    _graph_cache.grad_signature(watched))
            return self._graphs.get(
                key, self._nested_call, tensors[0].device,
                self._graph_tensors, type(self).__name__,
                params=self._grad_params)(*args)
        cc = self._graphs.get(key, self._nested_call, tensors[0].device,
                              self._graph_tensors, type(self).__name__)
        out = cc(*args)
        if self._aot_path is not None and cc.calls == 1:
            self._aot_export(key, out)
        return _fresh(out) if cc.static else out

    def stats(self):
        """This block's graphs: held, captures, replays, backward
        replays, busy calls run eagerly, capture and host seconds, and
        the pool's bytes (``graph_cache.CallCache.stats``); and the
        recorded calls run eagerly for a row-sparse gradient
        (``sparse_calls``)."""
        return dict(self._graphs.stats(), sparse_calls=self._sparse_calls)

    def _grad_params(self):
        return [t for t in self._graph_tensors() if t.requires_grad]

    def _sparse_grads(self):
        """Whether the tree holds a block whose recorded call gives a
        row-sparse gradient (``Block._sparse_grad``; looked up again only
        after the tree changed)."""
        gen = _graph_cache.tree_generation()
        seen = getattr(self, "_sparse_seen", None)
        if seen is None or seen[0] != gen:
            seen = (gen, any(isinstance(b, Block) and b._sparse_grad
                             for b in self.modules()))
            self._sparse_seen = seen
        return seen[1]

    def forward(self, *args):
        """``hybrid_forward`` with the JAX package's arguments (see the
        module docstring), for a block that defines it and no
        ``forward`` of its own."""
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise NotImplementedError(
                'Module [%s] is missing the required "forward" function'
                % type(self).__name__)
        return _hybrid_call(self, args)

    def hybrid_forward(self, F, x, *args, **params):
        """Parity: HybridBlock.hybrid_forward; a block defines it, or
        ``forward``."""
        raise NotImplementedError

    def _nested_call(self, *args):
        _nesting.depth = getattr(_nesting, "depth", 0) + 1
        try:
            return torch.nn.Module.__call__(self, *args)
        finally:
            _nesting.depth -= 1

    def _graph_tensors(self):
        """The tree's parameters and buffers, which a graph reads in
        place: collected again only after a module, parameter or buffer
        was registered or converted somewhere (a ``p.data`` swap keeps
        the object, and the graph's storage check sees it move)."""
        gen = _graph_cache.tree_generation()
        if self._watched is None or self._watched[0] != gen:
            self._watched = (gen, list(self.parameters())
                             + list(self.buffers()))
        return self._watched[1]


def _nd_in(a, cls=None):
    """A tensor argument as an array over it (no copy), of ``cls`` or
    else of the class the call was made with; anything else as it is."""
    if cls is None:
        cls = getattr(_calls, "cls", NDArray)
    if isinstance(a, torch.Tensor):
        return cls._wrap(a, Context.from_device(a.device))
    if isinstance(a, (tuple, list)):
        return type(a)(_nd_in(x, cls) for x in a)
    return a


def _tensors_out(out):
    """``hybrid_forward``'s NDArray outputs as their tensors."""
    if isinstance(out, NDArray):
        return out._data
    if isinstance(out, (tuple, list)):
        return type(out)(_tensors_out(o) for o in out)
    return out


def _hybrid_call(block, args):
    """Call ``block.hybrid_forward(nd, *inputs, **params)`` on NDArrays
    over ``args`` and the block's registered tensors.  Its ops run
    eagerly (``engine.unbulked``: nothing deferred inside a call, so
    nothing deferred outside it is flushed into a graph being captured),
    and recorded exactly when torch's grad mode is on (a
    ``JitTrainStep``'s body and a graph pair's capture differentiate
    them without ``autograd.record()``).  The wrappers live for the
    call only."""
    from .. import ndarray as _nd

    block._shape_hint(*args)
    params = {}
    for name, p in block._reg_params.items():
        t = p._tensor
        if isinstance(t, _LAZY):
            raise DeferredInitializationError(
                "parameter %r of %s has no shape yet: hybrid_forward "
                "blocks take theirs from shape= or from _shape_hint"
                % (p.name, block.name))
        params[name] = _nd_in(t, NDArray)
    with _engine.unbulked(), _autograd._RecordingStateScope(
            torch.is_grad_enabled(), None):
        out = block.hybrid_forward(_nd, *[_nd_in(a) for a in args],
                                   **params)
    return _tensors_out(out)


def cast_tensors(tensors, dtype):
    """Cast each floating-point tensor of ``tensors`` in place of its
    data (the object, and its memory format, kept); one whose shape is
    not known yet is made in ``dtype`` when it is."""
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, torch.nn.parameter.UninitializedTensorMixin):
            t.data = torch.empty(0, dtype=dtype, device=t.device)
        elif t.is_floating_point():
            t.data = t.data.to(dtype)


def _clear_caches(block):
    """Drop the captured graphs of every hybridized block in the tree."""
    for b in block.modules():
        if isinstance(b, HybridBlock):
            b.clear_cache()


def _fresh(out):
    """Copies of a graph's static outputs, which its next replay
    overwrites."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_fresh(o) for o in out)
    return out
