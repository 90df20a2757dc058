"""Learning-rate schedulers (parity: python/mxnet/lr_scheduler.py; the
port's copy of ``mxnet_tpu/lr_scheduler.py``).

The host schedules (``__call__``, with warmup and the anchor rule of the
stateful schedulers) are the JAX package's code.  ``traced(t)`` is a
torch function of a device int32 update count that gives the rate as a
0-d f32 tensor on the count's device, formed in f32 as the JAX package's
jnp version forms it, or None where the JAX package's returns None.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError


def _f32(x, device):
    return torch.tensor(float(x), dtype=torch.float32, device=device)


class LRScheduler:
    """Base scheduler: maps num_update -> learning rate."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode
        if warmup_begin_lr > base_lr:
            raise MXNetError("base lr must be larger than warmup_begin_lr")
        if warmup_steps < 0:
            raise MXNetError("warmup_steps must be >= 0")

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            increase = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / self.warmup_steps
            return self.warmup_begin_lr + increase
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        raise MXNetError("invalid warmup_mode %r" % self.warmup_mode)

    def _traced_warmup(self, t):
        begin = _f32(self.warmup_begin_lr, t.device)
        if self.warmup_mode == "constant" or self.warmup_steps == 0:
            return begin
        return begin + (
            (self.warmup_final_lr - self.warmup_begin_lr)
            * t.to(torch.float32) / self.warmup_steps)

    def _with_warmup(self, t, lr):
        if self.warmup_steps <= 0:
            return lr
        return torch.where(t < self.warmup_steps, self._traced_warmup(t), lr)

    def traced(self, t):
        """lr as a torch function of a device int32 update count ``t``
        (a 0-d f32 tensor on its device), for a step that reads its rate
        on the card.  Subclasses without a pure form return None."""
        return None

    _anchor = None

    def _ensure_anchor(self):
        # the pre-decay base lr for stateful schedulers: captured at first
        # use, AFTER the optimizer has adopted its learning_rate into
        # base_lr (reference semantics: the eager path decays base_lr in
        # place)
        if self._anchor is None:
            self._anchor = self.base_lr

    def __call__(self, num_update):  # pragma: no cover - abstract
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates (parity: FactorScheduler)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise MXNetError("schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise MXNetError("factor must be no more than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        self._ensure_anchor()
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr

    def traced(self, t):
        self._ensure_anchor()
        k = torch.clamp(torch.div(t - 1, self.step, rounding_mode="floor"),
                        min=0)
        lr = self._anchor * torch.pow(_f32(self.factor, t.device),
                                      k.to(torch.float32))
        return self._with_warmup(t, torch.clamp(lr,
                                                min=self.stop_factor_lr))


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at given steps (parity: MultiFactorScheduler)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise MXNetError("schedule step must be an increasing list")
            if _step < 1:
                raise MXNetError("schedule step must be greater than 1")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def traced(self, t):
        self._ensure_anchor()
        steps = torch.tensor(self.step, dtype=torch.int32, device=t.device)
        k = (t > steps).sum()
        lr = self._anchor * torch.pow(_f32(self.factor, t.device),
                                      k.to(torch.float32))
        return self._with_warmup(t, lr)

    def __call__(self, num_update):
        self._ensure_anchor()
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to final_lr over max_update steps."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise MXNetError("maximum number of updates must be strictly positive")
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) \
                * pow(1 - float(num_update - self.warmup_steps) /
                      float(self.max_steps), self.power)
        return self.base_lr

    def traced(self, t):
        tt = torch.clamp(t, max=self.max_update).to(torch.float32)
        frac = 1.0 - (tt - self.warmup_steps) / float(self.max_steps)
        lr = self.final_lr + (self.base_lr_orig - self.final_lr) \
            * frac ** self.power
        return self._with_warmup(t, lr)


class CosineScheduler(LRScheduler):
    """Cosine decay (parity: CosineScheduler)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise MXNetError("maximum number of updates must be strictly positive")
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) \
                * (1 + math.cos(
                    math.pi * (num_update - self.warmup_steps)
                    / self.max_steps)) / 2
        return self.base_lr

    def traced(self, t):
        tt = torch.clamp(t, max=self.max_update).to(torch.float32)
        lr = self.final_lr + (self.base_lr_orig - self.final_lr) * (
            1.0 + torch.cos(_f32(math.pi, t.device) * (tt - self.warmup_steps)
                            / float(self.max_steps))) / 2.0
        return self._with_warmup(t, lr)
