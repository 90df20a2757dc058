"""Gluon Trainer on one device (the port's counterpart of
``mxnet_tpu/gluon/trainer.py``).

The imperative form of training: ``loss.backward()`` fills each
parameter's ``.grad`` and ``step(batch_size)`` applies the optimizer to
every parameter in place, with ``rescale_grad = scale / batch_size``.
A step consumes the gradients (sets ``.grad`` to None), so a parameter
that the next backward does not reach raises the JAX package's stale
gradient error unless ``ignore_stale_grad=True``.  There is no kvstore:
the only one accepted is the default ``"device"``; distributed training
is slice S8 of the port.  ``params`` may hold tensors that take no
gradient (``collect_params()``'s running statistics, the JAX package's
``grad_req="null"``): a step leaves them alone.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .. import optimizer as opt_mod


class Trainer:
    """Parity: gluon.Trainer."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            params = list(params.items())
        elif isinstance(params, (list, tuple)):
            params = [("%d" % i, p) for i, p in enumerate(params)]
        else:
            raise MXNetError("params should be a list or a dict, got %s"
                             % type(params).__name__)
        if kvstore != "device" or compression_params is not None \
                or update_on_kvstore:
            raise MXNetError(
                "Trainer(kvstore=%r): only the single-device default "
                "'device' is ported; distributed training is slice S8 of "
                "the port (ROADMAP.md)" % (kvstore,))
        for name, p in params:
            if not isinstance(p, torch.Tensor):
                raise MXNetError("invalid parameter %s of type %s"
                                 % (name, type(p).__name__))
        self._names = [n for n, _ in params]
        self._params = [p for _, p in params]
        self._states = [None] * len(self._params)
        self._states_created = [False] * len(self._params)
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             **(optimizer_params or {}))
        self._optimizer.idx2name = dict(enumerate(self._names))
        self._scale = self._optimizer.rescale_grad

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
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """One optimizer update of every parameter with a fresh gradient."""
        opt = self._optimizer
        opt.rescale_grad = self._scale / batch_size
        active = []
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            if p.grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    "gradient of parameter %s has not been updated by "
                    "backward() since the last step; this could mean a bug "
                    "in your model that made it only use a subset of the "
                    "parameters for this iteration; pass "
                    "ignore_stale_grad=True to suppress" % self._names[i])
            active.append(i)
        for i in active:
            p = self._params[i]
            if not self._states_created[i]:
                self._states[i] = opt.create_state(i, p.detach())
                self._states_created[i] = True
            opt._update_count(i)
            opt._step(p.detach(), p.grad, self._states[i], opt._get_lr(i),
                      opt._get_wd(i), opt._index_update_count[i])
            p.grad = None
