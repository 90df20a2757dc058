"""Optimizers (the port's counterpart of ``mxnet_tpu/optimizer/optimizer.py``).

Every optimizer keeps the JAX package's update formula in ``_update``,
which ``_step(weight, grad, state, lr, wd, t)`` applies in place under
``torch.no_grad()`` (the JAX package returns new arrays instead) and
returns ``(weight, state)``.  Weights and state keep their dtype (state
is made in the weight's dtype, as in the JAX package); each op computes
in f32 internally and rounds once into the stored dtype, so a bf16 model
is updated in bf16 storage without f32 copies of its weights or state.
``adamw`` is the JAX package's rule, not ``torch.optim.AdamW``:
``lr_t = lr*sqrt(1-b2^t)/(1-b1^t)`` and
``w -= lr_t*m/(sqrt(v)+eps) + lr*wd*w`` with the old ``w``.

``lr`` and ``t`` are Python numbers (``gluon.Trainer``) or 0-d tensors
on the weights' device (``JitTrainStep``, whose captured step graph
reads them where the host wrote them before the replay, as the JAX
package's jitted step takes an f32 ``lr`` and an int32 ``t``).  With
tensors, ``lr_t`` is formed on the device in f32 from them, and every
product with a scalar is taken in f32 before the one rounding into the
weight's dtype.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

class Optimizer:
    """Base optimizer (parity: optimizer.Optimizer)."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- registry ---------------------------------------------------------
    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise MXNetError("cannot find optimizer %s" % name)
        return Optimizer.opt_registry[name.lower()](**kwargs)

    # -- lr / wd bookkeeping ----------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError(
                "LRScheduler of the optimizer has already been defined")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, mults, index):
        if index in mults:
            return mults[index]
        if index in self.idx2name:
            return mults.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        return self.learning_rate * self._mult(self.lr_mult, index)

    def _get_wd(self, index):
        return self.wd * self._mult(self.wd_mult, index)

    # -- state and update -------------------------------------------------
    def create_state(self, index, weight):
        """Per-parameter state: None, a tensor or a tuple of tensors."""
        return None

    def _zeros(self, weight):
        return torch.zeros_like(weight, memory_format=torch.contiguous_format)

    def _clip_rescale(self, grad):
        """``grad * rescale_grad``, clipped; a new tensor only when it
        differs from ``grad``."""
        if self.rescale_grad != 1.0:
            grad = grad * self.rescale_grad
        if self.clip_gradient is not None and self.clip_gradient >= 0:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        return grad

    def _update(self, weight, grad, state, lr, wd, t):
        """Apply the formula to ``weight`` and ``state`` in place."""
        raise NotImplementedError

    def _step(self, weight, grad, state, lr, wd, t):
        """Apply one update to ``weight`` and ``state`` in place; ``lr``
        and ``t`` are numbers or 0-d device tensors."""
        with torch.no_grad():
            self._update(weight, grad.to(weight.dtype), state,
                         _scalar(lr, float), float(wd), _scalar(t, int))
        return weight, state

    def __repr__(self):
        return "%s(lr=%s, wd=%s)" % (type(self).__name__,
                                     self.learning_rate, self.wd)


register = Optimizer.register


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def create(name, **kwargs):
    return Optimizer.create_optimizer(name, **kwargs)


def _scalar(x, kind):
    """A number as ``kind``, a tensor as it is."""
    return x if isinstance(x, torch.Tensor) else kind(x)


def _factor(a):
    """A device scalar as a 1-element f32 tensor: unlike a 0-d tensor it
    takes part in type promotion, so ``bf16 * factor`` is formed in f32
    inside one kernel, without an f32 copy of the bf16 operand."""
    return a.reshape(1).to(torch.float32)


def _axpy(w, x, a):
    """``w += a * x`` in place with one rounding into ``w``'s dtype; ``x``
    is at least f32.  A tensor ``a`` is multiplied in f32 (one kernel)."""
    if isinstance(a, torch.Tensor):
        w.addcmul_(x, _factor(a))
    else:
        w.add_(x, alpha=a)


def _decayed(g, weight, wd):
    """``g + wd * weight`` in at least f32, as the JAX rule forms it with
    an f32 ``wd``: never rounded into the weight's narrower dtype."""
    g = g.to(torch.promote_types(weight.dtype, torch.float32))
    return torch.add(g, weight, alpha=wd) if wd else g


@register
class SGD(Optimizer):
    """SGD with momentum (parity: optimizer.SGD)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else self._zeros(weight)

    def _update(self, weight, grad, state, lr, wd, t):
        # the JAX rule gets an f32 ``wd``, so the decayed gradient, the
        # step and the new weight are formed in f32 and rounded into the
        # weight's dtype once; bf16 arithmetic here would round twice
        g = _decayed(self._clip_rescale(grad), weight, wd)
        if state is None:
            _axpy(weight, g, -lr)
            return
        mom = (state * self.momentum).to(g.dtype)
        _axpy(mom, g, -lr)
        state.copy_(mom)
        weight.add_(mom)


@register
class Adam(Optimizer):
    """Adam with bias correction; ``wd*w`` is folded into the gradient
    (parity: optimizer.Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _lr_t(self, lr, t):
        return lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)

    def _device_scalars(self, lr, t, wd=0.0):
        """The step's device scalars, formed on the device in f32 (as the
        JAX package's jitted step forms ``lr_t``) once for all the
        parameters of a step, while ``lr`` and ``t`` keep their versions:
        with ``c = sqrt(1-b2^t)/(1-b1^t)`` and ``lr_t = lr*c``,
        ``-1/lr_t`` and ``-eps/lr_t``, ``wd/c`` (0-d) and ``-lr_t`` (a
        factor)."""
        key = tuple((id(x), x._version) if isinstance(x, torch.Tensor)
                    else x for x in (lr, t)) + (wd,)
        cached = getattr(self, "_scalar_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        dev = _device_of(lr, t)
        tf = torch.as_tensor(t, device=dev).float()
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        c = torch.sqrt(1.0 - self.beta2 ** tf) / (1.0 - self.beta1 ** tf)
        inv_lr_t = -1.0 / (lr * c)
        out = {"inv_lr_t": inv_lr_t, "eps_lr_t": self.epsilon * inv_lr_t,
               "wd_c": wd / c, "neg_lr_t": _factor(-lr * c)}
        # the key's tensors are kept alive, so their ids stay theirs
        self._scalar_cache = (key, out, lr, t)
        return out

    def _moments(self, g, state):
        """``m = b1 m + (1-b1) g`` and ``v = b2 v + (1-b2) g^2``, in
        place, each rounded once into the state's dtype."""
        mean, var = state
        # an f32 ``g`` (decay folded in) is not rounded to the state first
        torch.lerp(mean.to(g.dtype), g, 1 - self.beta1, out=mean)
        torch.lerp(var.to(g.dtype), g * g, 1 - self.beta2, out=var)
        return mean, var

    def _adam_step(self, weight, mean, var, lr, t, decay=0.0, wd=0.0):
        """``w <- w - lr_t * m / (sqrt(v) + eps) - decay * w`` from the old
        ``w``, in place.  The decay and the step are summed in f32 and
        added to ``w`` in one rounding, as in the JAX rule: a decay applied
        on its own would round back to ``w`` in bf16 whenever it is below
        half an ulp.

        With device scalars (``lr`` or ``t`` a tensor) the passes stay
        those of the number path, and a scalar goes only where a pass
        already takes one (a 0-d or broadcast tensor operand costs a pass
        its vectorized kernel): with the decoupled decay ``wd``,
        ``w += -lr_t * ((wd / c) * w + m / (sqrt(v) + eps))``; without it
        the denominator's pass becomes ``(sqrt(v) + eps) / -lr_t``."""
        wide = torch.promote_types(weight.dtype, torch.float32)
        if isinstance(lr, torch.Tensor) or isinstance(t, torch.Tensor):
            sc = self._device_scalars(lr, t, wd)
            if not wd:
                weight.addcdiv_(mean, torch.addcmul(
                    sc["eps_lr_t"], var.sqrt(), sc["inv_lr_t"]))
                return
            denom = var.sqrt().add_(self.epsilon)
            delta = torch.empty_like(weight, dtype=wide)
            torch.mul(weight, sc["wd_c"], out=delta)
            weight.addcmul_(delta.addcdiv_(mean, denom), sc["neg_lr_t"])
            return
        denom = var.sqrt().add_(self.epsilon)
        lr_t = self._lr_t(lr, t)
        if not decay:
            weight.addcdiv_(mean, denom, value=-lr_t)
            return
        delta = torch.empty_like(weight, dtype=wide)
        torch.mul(weight, -decay, out=delta)
        weight.add_(delta.addcdiv_(mean, denom, value=-lr_t))

    def _update(self, weight, grad, state, lr, wd, t):
        g = self._clip_rescale(grad)
        if wd:
            g = _decayed(g, weight, wd)
        mean, var = self._moments(g, state)
        self._adam_step(weight, mean, var, lr, t)


@register
class AdamW(Adam):
    """Decoupled weight decay Adam (parity: contrib adamw_update)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)

    def _update(self, weight, grad, state, lr, wd, t):
        mean, var = self._moments(self._clip_rescale(grad), state)
        self._adam_step(weight, mean, var, lr, t,
                        decay=lr * wd if wd else 0.0, wd=wd)
