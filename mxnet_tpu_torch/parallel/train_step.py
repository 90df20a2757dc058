"""JitTrainStep: forward, loss, backward and the optimizer in one call
(the port's counterpart of ``mxnet_tpu/parallel/train_step.py``).

The JAX package traces the step once and compiles it into one XLA
executable with donated weight buffers.  The port runs the same step
eagerly: ``step(*batch)`` runs the net and the loss in train mode,
takes the mean loss in f32, gets the gradients with
``torch.autograd.grad`` and applies the optimizer's update to every
trainable parameter in place, where the JAX package donates and
replaces them.  The weights and optimizer state keep their dtypes from
step to step (the JAX package pins them the same way).  The loss comes
back as a tensor on the device, without a sync.

Single device only: ``mesh=``, ``rules=`` and ``param_rule=`` are
sharded training, slice S8 of the port, and raise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .. import optimizer as _opt_mod


def _global_norm_scale(grads, max_norm):
    """The JAX package's global-norm clip: scale every gradient by
    ``min(max_norm / (norm + 1e-8), 1)``."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + g.float().square().sum()
    scale = torch.clamp(max_norm / (total.sqrt() + 1e-8), max=1.0)
    return [g * scale.to(g.dtype) for g in grads]


class JitTrainStep:
    """One training step of ``net`` + ``loss`` + ``optimizer`` per call.

    Parameters are those of the JAX package: ``net`` (initialized),
    ``loss`` (a loss block, or None when the net's first output is the
    loss), ``optimizer`` and ``optimizer_params``, ``clip_global_norm``.
    ``donate`` is accepted and means nothing here: updates are in place.
    The step runs where the net's parameters live.
    """

    def __init__(self, net, loss=None, optimizer="sgd",
                 optimizer_params=None, mesh=None, data_axis="data",
                 param_rule=None, donate=True, clip_global_norm=None,
                 rules=None):
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

    def _ensure_init(self, data):
        """Snapshot the parameters and make the optimizer state; one
        forward without gradients first resolves lazy shapes."""
        if self._params is not None:
            return
        lazy = torch.nn.parameter.UninitializedParameter
        if any(isinstance(p, lazy) for p in self._net.parameters()):
            with torch.no_grad():
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

    def step(self, *batch):
        """Run one train step; returns the loss (a device tensor)."""
        n_label = 1 if self._loss is not None else 0
        dev = next(self._net.parameters()).device
        arrays = [b.to(dev) if isinstance(b, torch.Tensor) else
                  torch.from_numpy(np.ascontiguousarray(b)).to(dev)
                  for b in batch]
        data, labels = arrays[:len(arrays) - n_label], \
            arrays[len(arrays) - n_label:]
        self._ensure_init(data)
        self._t += 1
        self._opt.num_update = self._t
        self._net.train()
        out = self._net(*data)
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        loss = self._loss(outs[0], *labels) if self._loss is not None \
            else outs[0]
        loss_val = loss.float().mean()
        train = [self._params[i] for i in self._train_idx]
        grads = list(torch.autograd.grad(loss_val, train))
        del out, outs, loss
        if self._clip_global_norm is not None:
            grads = _global_norm_scale(grads, self._clip_global_norm)
        lr = self._opt.learning_rate
        for j, i in enumerate(self._train_idx):
            lr_i = lr * self._opt.lr_mult.get(
                self._names[i], self._opt.lr_mult.get(i, 1.0))
            self._opt._step(self._params[i].detach(), grads[j],
                            self._opt_state[i], lr_i, self._opt._get_wd(i),
                            self._t)
            grads[j] = None
        self._last_loss = loss_val.detach()
        return self._last_loss

    def sync_params(self):
        """Kept for parity.  The JAX package copies its jitted weights
        back into the net here; the port updates the net's parameters in
        place, so there is nothing to copy."""
        return self

    @property
    def loss(self):
        return None if self._last_loss is None else float(self._last_loss)
