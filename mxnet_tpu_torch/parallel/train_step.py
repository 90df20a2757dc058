"""JitTrainStep: forward, loss, backward and the optimizer in one call
(the port's counterpart of ``mxnet_tpu/parallel/train_step.py``).

The JAX package traces the step once and compiles it into one XLA
executable with donated weight buffers.  The port's step runs the net
and the loss in train mode, takes the mean loss in f32, gets the
gradients with ``torch.autograd.grad``, clips them by their global norm
if asked and applies the optimizer's update to every trainable
parameter in place, where the JAX package donates and replaces them.
On the card the whole step is one captured CUDA graph per batch
signature (``graph_cache.CapturedCall``: the first call eager, the
second captured and replayed, later calls replayed).  As in the JAX
package, the learning rate (f32) and the update count (int32) are
device scalars that the graph reads: the host writes the learning rate
before each call and the step adds one to the count on the device, so
the eager and the graphed step run the same update code.  The update is
one ``_step_multi`` over every trainable parameter: on the card, for
SGD, NAG, Adam and AdamW, one multi-tensor kernel launch per group of
dtypes (``ops/optimizer_ops.py``: O1 or O2) that reads ``lr`` and the
count by pointer, with each parameter's ``lr_mult`` a factor in its
table; ``clip_global_norm`` takes its norm from O3.  The
per-parameter ``lr_mult``/``wd_mult``, ``wd``, ``rescale_grad`` and the
clips are constants of a captured step: changing one drops the graphs.
``step_n(n)`` runs n steps as n replays.  ``save_executable`` and
``load_executable`` write and check the step's signature in a bundle
(``compile_cache``), and the loading process captures the step ahead of
its first call, undoing the capture's warm-up.  ``save_states`` and
``load_states`` write and read the weights, the optimizer state and the
step count as the JAX package's MXGC1 file (``sharding/checkpoint.py``)
with its positional entry names (``weights/<i>``, ``opt/<i>/<j>``) and
meta: a file one package writes, the other reads.  The weights and
optimizer state keep their dtypes from step to step (the JAX package
pins them the same way).  The step runs in train mode (``autograd.train_mode()``), so
a ``BatchNorm`` takes batch statistics and writes its running statistics
in place, once a step; the JAX package returns them from its executable
and writes them after the update, which reads the same.  The graph
watches the net's buffers beside its parameters.  A hybridized net runs
eagerly inside the step (``block.calls_inline``): the step is captured
whole, and its capture must not replay the net's own graphs.  The loss comes back
as a tensor on the device, without a sync.

Single device only: ``mesh=``, ``rules=`` and ``param_rule=`` are
sharded training, slice S8 of the port, and raise.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import autograd as _autograd
from ..base import MXNetError
from .. import compile_cache as _ccache
from .. import graph_cache as _graph_cache
from .. import optimizer as _opt_mod
from .. import sharding as _shd
from ..gluon import block as _block
from ..gluon import utils as _gluon_utils
from ..gluon.trainer import _assign, _leaves


def _global_norm_scale(grads, max_norm):
    """The JAX package's global-norm clip (``gluon.utils``'s rule, the
    norm from one O3 read) on new tensors."""
    scale, _ = _gluon_utils.global_norm_scale(grads, max_norm)
    return [g * scale.to(g.dtype) for g in grads]


class JitTrainStep:
    """One training step of ``net`` + ``loss`` + ``optimizer`` per call.

    Parameters are those of the JAX package: ``net`` (initialized),
    ``loss`` (a loss block, or None when the net's first output is the
    loss), ``optimizer`` and ``optimizer_params``, ``clip_global_norm``.
    ``donate`` is accepted and means nothing here: updates are in place.
    The step runs where the net's parameters live; on the card as a
    captured graph unless ``graphs=False`` (every step eager: the same
    code, which tests and the chip smoke hold the graphs against).
    """

    def __init__(self, net, loss=None, optimizer="sgd",
                 optimizer_params=None, mesh=None, data_axis="data",
                 param_rule=None, donate=True, clip_global_norm=None,
                 rules=None, graphs=True):
        for name, v in (("mesh", mesh), ("param_rule", param_rule),
                        ("rules", rules)):
            if v is not None:
                raise MXNetError(
                    "JitTrainStep(%s=...): sharded training is slice S8 of "
                    "the port (ROADMAP.md); this port runs on one device"
                    % name)
        self._net = net
        self._loss = loss
        self._clip_global_norm = clip_global_norm
        if isinstance(optimizer, str):
            optimizer = _opt_mod.create(optimizer, **(optimizer_params or {}))
        self._opt = optimizer
        self._params = None
        self._t = 0
        self._last_loss = None
        self._batch_key = None      # the last step's batch signature
        self.graphs = bool(graphs)

    def _ensure_init(self, data):
        """Snapshot the parameters and make the optimizer state and the
        device scalars; one forward without gradients first resolves
        lazy shapes."""
        if self._params is not None:
            return
        lazy = torch.nn.parameter.UninitializedTensorMixin
        if any(isinstance(t, lazy) for t in itertools.chain(
                self._net.parameters(), self._net.buffers())):
            # predict mode: the running statistics stay as they are
            with torch.no_grad(), _autograd.predict_mode():
                self._net(*data)
        named = list(self._net.named_parameters())
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._train_idx = [i for i, p in enumerate(self._params)
                           if p.requires_grad]
        self._opt.idx2name = dict(enumerate(self._names))
        train = set(self._train_idx)
        self._opt_state = [
            self._opt.create_state(i, p.detach()) if i in train else None
            for i, p in enumerate(self._params)]
        dev = self._params[0].device
        self._lr = torch.zeros((), dtype=torch.float32, device=dev)
        self._count = torch.full((), self._t, dtype=torch.int32, device=dev)
        self._graphs = _graph_cache.CallCache()
        self._consts = None
        self._watch = self._params + [
            s for st in self._opt_state
            for s in (st if isinstance(st, tuple) else (st,))
            if s is not None] + list(self._net.buffers()) \
            + [self._lr, self._count]

    def _arrays(self, batch):
        dev = next(self._net.parameters()).device
        return [b.to(dev) if isinstance(b, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(b)).to(dev)
                for b in batch]

    def _split(self, arrays):
        n_label = 1 if self._loss is not None else 0
        return arrays[:len(arrays) - n_label], arrays[len(arrays) - n_label:]

    def _body(self, *arrays):
        """One step on the device: count, forward, loss, gradients, clip
        and update; what the graph captures.  Returns the f32 loss."""
        data, labels = self._split(arrays)
        self._count.add_(1)
        with _autograd.train_mode(), _block.grads_unwritten(), \
                _block.calls_inline():
            out = self._net(*data)
            outs = [out] if isinstance(out, torch.Tensor) else list(out)
            loss = self._loss(outs[0], *labels) if self._loss is not None \
                else outs[0]
        loss_val = loss.float().mean()
        train = [self._params[i] for i in self._train_idx]
        # a parameter the loss does not reach (a BERT MLM wrapper's
        # pooler) gets a zero gradient, as in the JAX package
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            train, torch.autograd.grad(loss_val, train, allow_unused=True))]
        del out, outs, loss
        if self._clip_global_norm is not None:
            grads = _global_norm_scale(grads, self._clip_global_norm)
        opt, idx = self._opt, self._train_idx
        opt._step_multi([self._params[i].detach() for i in idx], grads,
                        [self._opt_state[i] for i in idx], self._lr,
                        [opt._get_wd(i) for i in idx], self._count,
                        [opt._lr_mult(i) for i in idx])
        del grads
        return loss_val.detach()

    def _watched(self):
        return self._watch

    def _constants(self):
        """What a captured step reads as constants."""
        opt = self._opt
        return (tuple(sorted(opt.lr_mult.items(), key=repr)),
                tuple(sorted(opt.wd_mult.items(), key=repr)), opt.wd,
                opt.rescale_grad, opt.clip_gradient, self._clip_global_norm)

    def _run(self, arrays):
        self._batch_key = _graph_cache.signature(arrays)
        self._t += 1
        self._opt.num_update = self._t
        self._lr.fill_(self._opt.learning_rate)
        self._net.train()
        if not self.graphs:
            self._last_loss = self._body(*arrays)
            return self._last_loss
        consts = self._constants()
        if consts != self._consts:
            self._graphs.clear()
            self._consts = consts
        cc = self._graphs.get(_graph_cache.signature(arrays), self._body,
                              self._lr.device, self._watched, "JitTrainStep")
        if cc.graphed and cc.calls == 1:
            # the capture's pool needs the memory the eager step cached
            torch.cuda.empty_cache()
        loss = cc(*arrays)
        self._last_loss = loss.clone() if cc.static else loss
        return self._last_loss

    def step(self, *batch):
        """Run one train step; returns the loss (a device tensor)."""
        arrays = self._arrays(batch)
        self._ensure_init(self._split(arrays)[0])
        return self._run(arrays)

    def step_n(self, n, *batch):
        """Run ``n`` train steps on one batch and return the last loss
        (the JAX package's one-dispatch loop).  On the card each step is
        a replay of the step's graph; the count advances on the device
        and the learning rate, scheduled or not, is written before each
        replay (the reference's per-step fallback for a scheduler)."""
        arrays = self._arrays(batch)
        self._ensure_init(self._split(arrays)[0])
        loss = None
        for _ in range(int(n)):
            loss = self._run(arrays)
        return loss

    def stats(self):
        """The step's graphs (``graph_cache.CallCache.stats``)."""
        return self._graphs.stats() if self._params is not None else {}

    # -- saved executables (the compile cache's bundles) -------------------
    def _executable_entry(self, batch_key):
        """What a bundle holds of this step: the parameters' names, the
        weights' and the batch's signatures, the optimizer and the
        constants of its update, and whether the step is graphed."""
        opt = self._opt
        hyper = {k: v for k, v in sorted(vars(opt).items())
                 if not k.startswith("_") and k not in (
                     "lr", "num_update", "begin_num_update")
                 and (v is None or isinstance(v, (bool, int, float, str)))}
        return {"param_names": list(self._names),
                "weight_sig": [[list(p.shape), str(p.dtype),
                                _graph_cache.memory_format_of(p)]
                               for p in self._params],
                "batch_sig": _graph_cache.signature_to_wire(batch_key),
                "optimizer": type(opt).__name__.lower(),
                "hyperparameters": hyper,
                "constants": repr(self._constants()),
                "graphed": self.graphs}

    def save_executable(self, fname):
        """Save this step's signature as a bundle (``compile_cache``): a
        fresh process's ``load_executable`` checks it and captures the
        step ahead of its first call, which is then a replay.  Run one
        step first.  Pairs with ``save_states``: this file carries the
        program's signature, the checkpoint the data."""
        if self._params is None or self._batch_key is None:
            raise MXNetError("save_executable before the first step: run "
                             "one step so the step's signature exists")
        _ccache.save_bundle(fname, {"step": self._executable_entry(
            self._batch_key)}, meta={"kind": "train_step"})

    def load_executable(self, fname, *batch):
        """Check ``save_executable``'s bundle against this step and, on
        the card with graphs on, capture the step for ``batch`` (one
        example batch of the training shapes) ahead of the first
        ``step``, which is then a replay.  Nothing is stepped on: the
        weights, the optimizer state, the running statistics and the
        count are as they were (the capture's warm-up is undone).  A
        bundle of another net, batch signature, optimizer or graph
        setting raises ``MXNetError`` here, as does a bad magic or
        another card's capability."""
        arrays = self._arrays(batch)
        self._ensure_init(self._split(arrays)[0])
        doc = _ccache.load_bundle(fname)
        entry = doc["entries"].get("step")
        if entry is None or doc.get("meta", {}).get("kind") != "train_step":
            raise MXNetError("%s is not a JitTrainStep bundle" % fname)
        key = _graph_cache.signature(arrays)
        want = self._executable_entry(key)
        for field, what in (("param_names", "parameters"),
                            ("weight_sig", "weight signature"),
                            ("batch_sig", "batch signature"),
                            ("optimizer", "optimizer"),
                            ("hyperparameters", "optimizer hyperparameters"),
                            ("constants", "update constants"),
                            ("graphed", "graph setting")):
            if entry.get(field) != want[field]:
                raise MXNetError(
                    "load_executable: %s mismatch: the bundle %s has %s but "
                    "this step has %s" % (what, fname, entry.get(field),
                                          want[field]))
        self._batch_key = key
        if self.graphs:
            self._consts = self._constants()
            self._lr.fill_(self._opt.learning_rate)
            self._net.train()
            cc = self._graphs.get(key, self._body, self._lr.device,
                                  self._watched, "JitTrainStep")
            _ccache.count_aot_loads(int(cc.prepare(arrays,
                                                   restore=self._watch)))
        return self

    def sync_params(self):
        """Kept for parity.  The JAX package copies its jitted weights
        back into the net here; the port updates the net's parameters in
        place, so there is nothing to copy."""
        return self

    def save_states(self, fname):
        """The weights, the optimizer state and the step count as an
        MXGC1 checkpoint: ``weights/<i>`` and ``opt/<i>/<j>`` by the
        parameters' positions (the JAX package's keys: names differ
        between processes, the order does not), each with a crc32,
        written atomically."""
        if self._params is None:
            raise MXNetError("save_states before the first step")

        def entries():
            for i, p in enumerate(self._params):
                yield "weights/%d" % i, p, None
            for i, st in enumerate(self._opt_state):
                for j, leaf in enumerate(_leaves(st)):
                    yield "opt/%d/%d" % (i, j), leaf, None
        _shd.save_global(fname, entries(), meta={
            "kind": "jit_train_step", "t": int(self._t),
            "param_names": list(self._names),
            "opt_leaves": [len(_leaves(st)) for st in self._opt_state]})

    def load_states(self, fname):
        """Read ``save_states``' file (the JAX package's too) into the
        live weights and optimizer state, in place, and the step count.
        As in the JAX package, run one step first: the state exists from
        then on."""
        if self._params is None:
            raise MXNetError(
                "load_states needs initialized placement: run one step, "
                "or call after net.initialize + a step")
        if not _shd.is_global_checkpoint(fname):
            raise MXNetError("checkpoint %s is not an MXGC1 file" % fname)
        entries, meta = _shd.load_global(fname)
        what = "checkpoint %s" % fname

        def load(tensor, name, why):
            ent = entries.get(name)
            if ent is None:
                raise MXNetError("%s: missing entry %r (%s)"
                                 % (what, name, why))
            _assign(tensor, ent["array"], ent["dtype"], name, what)

        for i, p in enumerate(self._params):
            load(p, "weights/%d" % i, "param %s: the file was written by a "
                 "different net" % self._names[i])
        for i, st in enumerate(self._opt_state):
            for j, leaf in enumerate(_leaves(st)):
                load(leaf, "opt/%d/%d" % (i, j), "optimizer config changed?")
        self._t = int(meta.get("t", 0))
        self._opt.num_update = self._t
        self._count.fill_(self._t)

    @property
    def loss(self):
        return None if self._last_loss is None else float(self._last_loss)
