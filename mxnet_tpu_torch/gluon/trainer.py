"""Gluon Trainer on one device (the port's counterpart of
``mxnet_tpu/gluon/trainer.py``).

The imperative form of training: ``loss.backward()`` fills each
parameter's ``.grad`` and ``step(batch_size)`` applies the optimizer to
every parameter in place, with ``rescale_grad = scale / batch_size``.
``params`` is a ``ParameterDict`` (``net.collect_params()``), a dict or
a list of ``gluon.Parameter``s, as in the JAX package; the optimizer
gets them as its ``param_dict``, so each one's ``lr_mult`` and
``wd_mult`` apply.  A dict or list of raw tensors is also taken (the
port's own form: those read the optimizer's ``lr_mult``/``wd_mult`` by
name or index).
Gradients follow the JAX package's ``grad_req="write"``: each backward
overwrites ``.grad`` and marks it fresh (``block.write_grads``: a
block's calls arm its parameters; a tensor that no block owns, raw or
a standalone Parameter's, is armed by a hook the Trainer puts on the
tensor, which holds no autograd node); a step leaves the gradient
readable and marks it stale, so a parameter that the next backward does
not reach raises the JAX package's stale gradient error unless
``ignore_stale_grad=True``.
There is no kvstore: the only one accepted is the default ``"device"``;
distributed training is slice S8 of the port.  A parameter with
``grad_req="null"`` (``collect_params()``'s running statistics, or a
frozen one) is left alone by a step; one with ``"add"`` keeps its
accumulated gradient through the step.

A step updates every parameter through the optimizer's
``_step_multi``: one call per update count (counts differ per index
only under ``ignore_stale_grad``), whose learning rate and count the
Trainer writes into two device scalars first, so SGD, NAG, Adam and
AdamW launch one multi-tensor kernel per group of dtypes on the card.
A parameter whose gradient is row-sparse (torch's sparse COO ``.grad``,
from ``Embedding(sparse_grad=True)``) leaves those groups and takes the
optimizer's lazy update (``Optimizer.update`` with a
``RowSparseNDArray``: O8, one launch a parameter, for SGD, Adam and
AdaGrad), as the JAX package's Trainer
sends it to its sparse executable; no sparse tensor reaches
``_step_multi``.
``save_states``/``load_states`` write and read the JAX package's MXGC1
format (``sharding/checkpoint.py``) with its entry names and meta, and
read its legacy pickles: a file one package writes, the other reads.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context
from ..ndarray.sparse import RowSparseNDArray
from .. import optimizer as opt_mod
from .. import sharding as _shd
from .block import write_grads_when_reached
from .parameter import Parameter, ParameterDict

_LAZY = torch.nn.parameter.UninitializedTensorMixin


class Trainer:
    """Parity: gluon.Trainer."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.items())
        elif isinstance(params, (list, tuple)):
            params = [("%d" % i, p) for i, p in enumerate(params)]
        else:
            raise MXNetError("params should be a list, a dict or a "
                             "ParameterDict, got %s" % type(params).__name__)
        if kvstore != "device" or compression_params is not None \
                or update_on_kvstore:
            raise MXNetError(
                "Trainer(kvstore=%r): only the single-device default "
                "'device' is ported; distributed training is slice S8 of "
                "the port (ROADMAP.md)" % (kvstore,))
        self._handles = []       # a Parameter per entry (None: a tensor)
        self._raw = []           # the raw tensors
        for name, p in params:
            if isinstance(p, Parameter):
                self._handles.append(p)
                self._raw.append(None)
                t = p._tensor
            elif isinstance(p, torch.Tensor):
                self._handles.append(None)
                self._raw.append(p)
                t = p
            else:
                raise MXNetError("invalid parameter %s of type %s"
                                 % (name, type(p).__name__))
            if t is not None and not isinstance(t, _LAZY) \
                    and not getattr(t, "_block_owned", False):
                write_grads_when_reached(t)
        self._names = [p.name if isinstance(p, Parameter) else n
                       for n, p in params]
        self._states = [None] * len(self._handles)
        self._states_created = [False] * len(self._handles)
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             **(optimizer_params or {}))
        self._optimizer.idx2name = dict(enumerate(self._names))
        self._optimizer.param_dict = {
            i: h for i, h in enumerate(self._handles) if h is not None}
        self._scale = self._optimizer.rescale_grad
        self._scalars = {}

    @property
    def _params(self):
        """The tensors, in order (a Parameter's is made if need be)."""
        return [h._ensure_tensor() if h is not None else t
                for h, t in zip(self._handles, self._raw)]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1/batch_size`` and apply one update."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum gradients across devices: a no-op on one device, as in the
        JAX package (kvstore training is S8)."""

    def _ensure_states(self):
        for i, p in enumerate(self._params):
            if not self._states_created[i] and p.requires_grad \
                    and not isinstance(p, _LAZY):
                self._states[i] = self._optimizer.create_state(i, p.detach())
                self._states_created[i] = True

    def _scalars_on(self, device):
        """The f32 learning rate and int32 count the kernels read on
        ``device``, written by a fill before each group's launch."""
        pair = self._scalars.get(device)
        if pair is None:
            pair = (torch.zeros((), dtype=torch.float32, device=device),
                    torch.zeros((), dtype=torch.int32, device=device))
            self._scalars[device] = pair
        return pair

    def update(self, batch_size, ignore_stale_grad=False):
        """One optimizer update of every parameter with a fresh gradient:
        one ``_step_multi`` per (device, update count, learning rate)."""
        opt = self._optimizer
        opt.rescale_grad = self._scale / batch_size
        params = self._params
        active = []
        for i, p in enumerate(params):
            if not p.requires_grad:
                continue
            if isinstance(p, _LAZY) or (self._handles[i] is not None and
                                        self._handles[i]._data is None):
                if ignore_stale_grad:
                    continue
                raise MXNetError("parameter %s has not been initialized"
                                 % self._names[i])
            if p.grad is None or not getattr(p, "_fresh_grad", False):
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    "gradient of parameter %s has not been updated by "
                    "backward() since the last step; this could mean a bug "
                    "in your model that made it only use a subset of the "
                    "parameters for this iteration; pass "
                    "ignore_stale_grad=True to suppress" % self._names[i])
            active.append(i)
        self._ensure_states()
        dense = []
        for i in active:
            if not params[i].grad.is_sparse:
                dense.append(i)
                continue
            rsp = RowSparseNDArray._from_torch(
                params[i].grad, Context.from_device(params[i].device))
            opt.update(i, params[i].detach(), rsp, self._states[i])
        groups = {}
        for i in dense:
            opt._update_count(i)
            key = (params[i].device, opt._index_update_count[i],
                   opt.learning_rate)
            groups.setdefault(key, []).append(i)
        for (dev, t, lr), idx in groups.items():
            lr_dev, t_dev = self._scalars_on(dev)
            lr_dev.fill_(lr)
            t_dev.fill_(t)
            opt._step_multi(
                [params[i].detach() for i in idx],
                [params[i].grad for i in idx],
                [self._states[i] for i in idx], lr_dev,
                [opt._get_wd(i) for i in idx], t_dev,
                [opt._lr_mult(i) for i in idx])
        for i in active:
            params[i]._fresh_grad = False

    # ------------------------------------------------------------------
    def save_states(self, fname):
        """The optimizer state as an MXGC1 checkpoint: every state leaf
        stored once as ``state/<i>/<j>`` with a crc32, written
        atomically, and the update counts in the meta (the JAX package's
        format and names)."""
        self._ensure_states()

        def entries():
            for i, st in enumerate(self._states):
                for j, leaf in enumerate(_leaves(st)):
                    yield "state/%d/%d" % (i, j), leaf, None
        opt = self._optimizer
        _shd.save_global(fname, entries(), meta={
            "kind": "trainer",
            "num_update": int(opt.num_update),
            "index_update_count": {
                str(k): int(v) for k, v in opt._index_update_count.items()},
        })

    def load_states(self, fname):
        """Read ``save_states``' file (or a legacy pickle of the JAX
        package's) into the live states, in place: each state keeps its
        dtype, device and strides."""
        self._ensure_states()
        opt = self._optimizer
        if _shd.is_global_checkpoint(fname):
            entries, meta = _shd.load_global(fname)
            for i, st in enumerate(self._states):
                for j, leaf in enumerate(_leaves(st)):
                    name = "state/%d/%d" % (i, j)
                    ent = entries.get(name)
                    if ent is None:
                        raise MXNetError(
                            "trainer checkpoint %s: missing entry %r "
                            "(optimizer config changed?)" % (fname, name))
                    _assign(leaf, ent["array"], ent["dtype"], name)
            opt.num_update = int(meta["num_update"])
            opt._index_update_count = {
                int(k): int(v) for k, v in meta["index_update_count"].items()}
            return
        try:
            with open(fname, "rb") as f:
                payload = pickle.load(f)
        except Exception as e:  # noqa: BLE001 — a torn legacy pickle
            raise MXNetError(
                "trainer checkpoint %s is neither MXGC1 nor a loadable "
                "legacy pickle (%s: %s) — corrupt or truncated"
                % (fname, type(e).__name__, e))
        for i, (st, saved) in enumerate(zip(self._states,
                                            payload["states"])):
            saved = _leaves(saved)
            for j, leaf in enumerate(_leaves(st)):
                arr = np.asarray(saved[j])
                _assign(leaf, arr, str(arr.dtype), "state/%d/%d" % (i, j))
        opt.num_update = payload["num_update"]
        opt._index_update_count = dict(payload["index_update_count"])


def _leaves(state):
    """A state's tensors in order (the JAX package's tree leaves)."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _assign(leaf, arr, dtype, name, what="trainer checkpoint"):
    """Copy a checkpoint entry into a live tensor, in place."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype == "bfloat16":
        host = host.view(torch.bfloat16)
    if tuple(host.shape) != tuple(leaf.shape):
        raise MXNetError("%s: %s has shape %s, the live tensor %s"
                         % (what, name, tuple(host.shape),
                            tuple(leaf.shape)))
    with torch.no_grad():
        leaf.copy_(host)
