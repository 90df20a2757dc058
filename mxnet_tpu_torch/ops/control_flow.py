"""Control-flow operators: ``foreach``, ``while_loop`` and ``cond``.

The port's counterpart of the JAX package's ``ops/control_flow.py``
(reference: ``src/operator/control_flow.cc:475-531`` and
``python/mxnet/ndarray/contrib.py``: foreach:216, while_loop:360,
cond:537), with its documented semantics.  The bodies are Python
callables over NDArrays, and the loops are Python loops:

- ``foreach`` runs ``body`` once a row of ``data`` (the count is a
  shape, so it captures into a CUDA graph);
- ``while_loop`` requires ``max_iterations``.  Outside
  ``autograd.record()`` it runs ``max_iterations`` steps with a liveness
  flag on the device, as the JAX package's masked scan does: the outputs
  are padded with zero rows to ``max_iterations``, the loop variables
  stop changing once ``cond`` fails, and nothing is read on the host.
  Inside ``record()`` it is the reference's imperative loop, trimmed to
  the steps taken: reading ``cond`` is a host sync, and under a CUDA
  graph capture it raises ``MXNetError``;
- ``cond`` reads its predicate on the host and runs only the taken
  branch (the JAX package's concrete-predicate path); under a capture
  it raises ``MXNetError``.

Inside ``record()`` every step records, so gradients reach the arrays a
body closes over too.  The registered ops ``_foreach``, ``_while_loop``
and ``_cond`` take their bodies as callable attrs and run through
``registry.register_invoke_override``.
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import graph_cache as _graph_cache
from ..base import MXNetError
from . import registry as _reg


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stack(arrays):
    from .. import ndarray as nd

    return nd.stack(*arrays, axis=0)


def foreach(body, data, init_states):
    """Iterate ``body(data_t, states) -> (outputs, new_states)`` over
    axis 0 (parity: ``mx.nd.contrib.foreach``): ``(outputs stacked on
    axis 0, final states)``, nested as the inputs are (a single NDArray
    in, a single one out)."""
    data_list = _as_list(data)
    data_single = not isinstance(data, (list, tuple))
    states_single = not isinstance(init_states, (list, tuple))
    states = init_states
    outs_acc = None
    out_single = True
    for t in range(data_list[0].shape[0]):
        xs = [d[t] for d in data_list]
        outs, states = body(xs[0] if data_single else xs, states)
        outs_l = _as_list(outs)
        if outs_acc is None:
            outs_acc = [[] for _ in outs_l]
            out_single = not isinstance(outs, (list, tuple))
        for acc, o in zip(outs_acc, outs_l):
            acc.append(o)
    if outs_acc is None:
        return [], states
    stacked = [_stack(acc) for acc in outs_acc]
    if states_single and isinstance(states, (list, tuple)) \
            and len(states) == 1:
        states = states[0]
    return (stacked[0] if out_single else stacked), states


def _pred(p, what):
    """``p`` (an NDArray or a number) as a Python bool: a host read of a
    device array, refused under a CUDA graph capture."""
    from ..ndarray.ndarray import NDArray

    if isinstance(p, NDArray):
        t = p.data()
        _graph_cache.refuse_host_read(what, t)
        return bool(t.reshape(-1)[0].item())
    return bool(p)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Loop ``func(*loop_vars) -> (outputs, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most ``max_iterations`` times (parity:
    ``mx.nd.contrib.while_loop``; see the module docstring for the two
    modes).  Returns ``(outputs stacked on axis 0, final loop vars)``."""
    from ..ndarray.ndarray import NDArray

    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations (the JAX "
                         "package's static-shape rule)")
    lv = _as_list(loop_vars)
    n_lv = len(lv)
    single_lv = not isinstance(loop_vars, (list, tuple))
    outs_acc, out_single = None, True
    if autograd.is_recording():
        steps = 0
        while steps < max_iterations and _pred(cond(*lv), "while_loop"):
            outs, new_lv = func(*lv)
            lv = _as_list(new_lv)
            outs_l = _as_list(outs)
            if outs_acc is None:
                outs_acc = [[] for _ in outs_l]
                out_single = not isinstance(outs, (list, tuple))
            for acc, o in zip(outs_acc, outs_l):
                acc.append(o)
            steps += 1
        stacked = [_stack(acc) for acc in (outs_acc or [])]
        outs_ret = stacked[0] if out_single and stacked else stacked
        return outs_ret, (lv[0] if single_lv else lv)

    # the masked loop: max_iterations steps, a liveness flag on the device
    def alive_of(vars_):
        return cond(*vars_).data().reshape(-1)[0].to(torch.bool)

    with autograd.pause():
        alive = alive_of(lv)
        for _ in range(int(max_iterations)):
            outs, new_lv = func(*lv)
            new_l = _as_list(new_lv)
            if len(new_l) != n_lv:
                raise MXNetError("func must return as many loop_vars as it "
                                 "received")
            outs_l = _as_list(outs)
            if outs_acc is None:
                outs_acc = [[] for _ in outs_l]
                out_single = not isinstance(outs, (list, tuple))
            for acc, o in zip(outs_acc, outs_l):
                d = o.data()
                acc.append(torch.where(alive, d, torch.zeros_like(d)))
            lv = [NDArray._wrap(torch.where(alive, n.data(), o.data()),
                                o.context) for n, o in zip(new_l, lv)]
            alive = alive & alive_of(lv)
    ctx = lv[0].context if lv else None
    stacked = [NDArray._wrap(torch.stack(acc, dim=0), ctx)
               for acc in (outs_acc or [])]
    outs_ret = stacked[0] if out_single and stacked else stacked
    return outs_ret, (lv[0] if single_lv else lv)


def cond(pred, then_func, else_func):
    """Run ``then_func()`` if ``pred`` else ``else_func()`` (parity:
    ``mx.nd.contrib.cond``): only the taken branch runs, fully recorded.
    ``pred`` is read on the host."""
    return then_func() if _pred(pred, "cond") else else_func()


# ---------------------------------------------------------------------------
# the registered ops: the bodies arrive as callable attrs
# ---------------------------------------------------------------------------


def _foreach_op(inputs, attrs, out):
    body = attrs.get("body")
    if not callable(body):
        raise MXNetError("_foreach: pass body= (callable), the op-name form "
                         "of nd.contrib.foreach")
    n_data = int(attrs.get("num_data", 1))
    data, states = list(inputs[:n_data]), list(inputs[n_data:])
    if not data:
        raise MXNetError("_foreach: needs at least one data input")
    outs, final = foreach(body, data if len(data) != 1 else data[0],
                          states if len(states) != 1 else states[0])
    return tuple(_as_list(outs) + _as_list(final))


def _while_loop_op(inputs, attrs, out):
    cond_fn, func = attrs.get("cond"), attrs.get("func")
    if not (callable(cond_fn) and callable(func)):
        raise MXNetError("_while_loop: pass cond= and func= callables, the "
                         "op-name form of nd.contrib.while_loop")
    outs, final = while_loop(
        cond_fn, func, list(inputs),
        max_iterations=int(attrs.get("max_iterations", 0)) or None)
    return tuple(_as_list(outs) + _as_list(final))


def _cond_op(inputs, attrs, out):
    pred, then_fn, else_fn = (attrs.get("cond"), attrs.get("then_func"),
                              attrs.get("else_func"))
    if not (callable(pred) and callable(then_fn) and callable(else_fn)):
        raise MXNetError("_cond: pass cond=, then_func=, else_func= "
                         "callables, the op-name form of nd.contrib.cond")
    return tuple(_as_list(cond(pred(*inputs), lambda: then_fn(*inputs),
                               lambda: else_fn(*inputs))))


def _on_tensors(op):
    """The registered forward: ``op`` over NDArrays wrapping the tensors,
    its outputs as tensors."""
    def forward(*arrays, **attrs):
        from ..context import Context
        from ..ndarray.ndarray import NDArray

        nds = [NDArray._wrap(a, Context.from_device(a.device))
               for a in arrays]
        return tuple(o.data() for o in op(nds, attrs, None))

    forward.__doc__ = op.__doc__
    return forward


for _name, _op in (("_foreach", _foreach_op), ("_while_loop", _while_loop_op),
                   ("_cond", _cond_op)):
    _reg.register(_name)(_on_tensors(_op))
    _reg.register_invoke_override(_name, _op)
