"""Blocks: ``Block`` and ``HybridBlock`` as ``torch.nn.Module``s.

The port's counterpart of ``mxnet_tpu/gluon/block.py``.  A block is a
module whose ``forward`` is plain torch; the JAX package's
``hybrid_forward(F, ...)`` dispatch does not exist here.  Parameters are
``torch.nn.Parameter``s named by structure (``blocks.0.attn.q_proj.weight``),
which are the JAX package's ``_collect_params_with_prefix()`` names, so
``state_dict()`` keys equal them.  A parameter may carry an ``init``
attribute (``"ones"``, ``"zeros"`` or an ``Initializer``) that overrides
the initializer given to ``initialize``, as in the JAX package.

Running statistics (``nn.BatchNorm``'s) are buffers, listed by
``collect_params()`` beside the parameters as the JAX package lists its
``grad_req="null"`` parameters; a buffer may carry an ``init`` too.

Gradients follow the JAX package's default ``grad_req="write"``: each
``backward()`` overwrites a parameter's ``.grad`` (contributions within
one backward, as a tied weight's, are summed), where torch would add to
it.  When the outermost block call of a thread returns with grad mode
on, :func:`write_grads` arms each of the tree's parameters: a pre-hook
on the ``AccumulateGrad`` node the call's graph holds for it drops the
old ``.grad`` and marks the new one fresh (``p._fresh_grad``;
``gluon.Trainer`` reads and clears the mark).  The node runs only when
torch accumulates into ``.grad``, so ``torch.autograd.grad``
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
reference's cached jitted vjp.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import weakref

import torch

from .. import autograd as _autograd
from .. import graph_cache as _graph_cache
from .. import initializer as _init
from ..base import MXNetError
from ..context import resolve

# how deep this thread is inside a hybridized block's call: the blocks
# it calls run eagerly and are captured with it (the reference's
# is_tracing())
_nesting = threading.local()
# how deep this thread is inside block calls, and whether the outermost
# call arms its parameters (write_grads) when it returns
_calls = threading.local()

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def as_dtype(dtype):
    """A ``torch.dtype`` from a dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise MXNetError("unsupported dtype %r (one of %s)"
                         % (dtype, sorted(_DTYPES)))


def new_param(shape, device, dtype="float32", init=None):
    """An uninitialized parameter (filled by ``Block.initialize``)."""
    p = torch.nn.Parameter(torch.empty(shape, dtype=as_dtype(dtype),
                                       device=resolve(device)))
    p.init = init
    return p


def _overwrite(ref, grad_outputs):
    p = ref()
    if p is not None:
        p.grad = None
        p._fresh_grad = True


def write_grads(params):
    """Arm each tensor of ``params`` that takes a gradient for the
    ``grad_req="write"`` rule (see the module docstring): a pre-hook on
    the ``AccumulateGrad`` node its graph holds for it, once a node.  No
    node is held here: one that no graph holds is freed on return.  The
    node is found through a view, as ``torch.autograd.graph.
    get_gradient_edge`` finds it, without that function's own checks
    (which cost as much again per parameter)."""
    with torch.enable_grad():
        for p in params:
            if not p.requires_grad or not p.is_leaf or isinstance(
                    p, torch.nn.parameter.UninitializedTensorMixin):
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


class Block(torch.nn.Module):
    """Base block (parity: gluon.Block).  ``prefix``/``params`` are
    accepted for the JAX package's signatures; names are structural."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        del prefix, params
        self._deferred_init = None    # (init, generator) for lazy shapes
        self._params_seen = None      # (tree generation, parameters)

    def __call__(self, *args, **kwargs):
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

    def register_parameter(self, name, param):
        super().register_parameter(name, param)
        if param is not None:
            param._block_owned = True     # armed by its block's calls

    def _tree_params(self):
        """The tree's parameters, collected again only after a module,
        parameter or buffer was registered or converted somewhere."""
        gen = _graph_cache.tree_generation()
        if self._params_seen is None or self._params_seen[0] != gen:
            self._params_seen = (gen, list(self.parameters()))
        return self._params_seen[1]

    def collect_params(self):
        """``{structural name: tensor}``, each block's parameters and then
        its buffers (running statistics, which take no gradient: the JAX
        package's ``grad_req="null"``), block by block in registration
        order."""
        out = {}
        for prefix, module in self.named_modules():
            for name, t in itertools.chain(module._parameters.items(),
                                           module._buffers.items()):
                if t is not None:
                    out[prefix + "." + name if prefix else name] = t
        return out

    def initialize(self, init=None, device=None, verbose=False,
                   force_reinit=False, generator=None):
        """Fill every parameter from ``init`` (default ``Uniform()``), or
        from the parameter's own ``init`` where it has one, drawing from
        ``generator``.  A parameter initialized before is left alone
        unless ``force_reinit``.  Parameters whose shape is known only at
        the first forward (``Dense(in_units=0)``) are filled then.
        ``device`` is accepted for parity: parameters live where their
        block was built."""
        del device, verbose
        default = _init.create(init)
        for module in self.modules():
            module._deferred_init = (default, generator)
        for name, p in itertools.chain(
                self.named_parameters(),
                ((n, b) for n, b in self.named_buffers()
                 if hasattr(b, "init"))):
            if isinstance(p, torch.nn.parameter.UninitializedTensorMixin):
                continue
            if getattr(p, "_initialized", False) and not force_reinit:
                continue
            fill_param(name, p, default, generator)
        if force_reinit:
            _clear_caches(self)
        return self

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
        # tree's dicts without registering them
        out = super()._apply(fn, *args, **kwargs)
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
    the same key runs eagerly (``stats()["busy_calls"]``).  The graphs
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

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  lint=False, aot=None, **kwargs):
        """Arm or disarm graph capture (parity: HybridBlock.hybridize).
        ``static_alloc`` and ``static_shape`` are accepted for parity: a
        graph's buffers are static by construction.  ``aot=`` (the
        persistent compile cache) and ``lint=True`` (the mxlint passes)
        are not ported and raise."""
        if aot is not None:
            raise MXNetError("hybridize(aot=...) is not ported yet: the "
                             "persistent compile cache comes with slice S5c "
                             "(ROADMAP.md)")
        if active and lint:
            raise MXNetError("hybridize(lint=True) is not ported yet: the "
                             "mxlint passes come with slice S9 (ROADMAP.md)")
        self._active = bool(active)
        if not active:
            self.clear_cache()
        return super().hybridize(active, static_alloc=static_alloc,
                                 static_shape=static_shape, **kwargs)

    def clear_cache(self):
        """Drop every captured graph of this block."""
        self._graphs.clear()
        self._watched = None

    def _call(self, *args, **kwargs):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not self._active or kwargs or not tensors \
                or getattr(_nesting, "depth", 0):
            return super()._call(*args, **kwargs)
        key = _graph_cache.signature(args, _autograd.is_training())
        watched = self._graph_tensors()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in tensors + watched):
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
        return _fresh(out) if cc.static else out

    def stats(self):
        """This block's graphs: held, captures, replays, backward
        replays, busy calls run eagerly, capture and host seconds, and
        the pool's bytes (``graph_cache.CallCache.stats``)."""
        return self._graphs.stats()

    def _grad_params(self):
        return [t for t in self._graph_tensors() if t.requires_grad]

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


def fill_param(name, p, default, generator):
    """Initialize ``p`` in place from its own ``init`` or ``default``.  A
    bf16 or f16 parameter is drawn in f32 and rounded once, as the JAX
    package draws (so a parameter cast before its deferred fill gets
    the values of one cast after it)."""
    own = getattr(p, "init", None)
    initializer = _init.create(own) if own is not None else default
    with torch.no_grad():
        if p.dtype in (torch.bfloat16, torch.float16):
            full = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            p.data.copy_(initializer(name, full, generator=generator))
        else:
            initializer(name, p.data, generator=generator)
    p._initialized = True
