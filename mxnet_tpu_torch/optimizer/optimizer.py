"""Optimizers (the port's counterpart of ``mxnet_tpu/optimizer/optimizer.py``).

Every optimizer keeps the JAX package's update formula.  ``_step(weight,
grad, state, lr, wd, t)`` applies it in place under ``torch.no_grad()``
(the JAX package returns new arrays instead) and returns ``(weight,
state)``; ``_step_multi(weights, grads, states, lr, wds, t, lr_mults)``
applies it to a list of tensors that share ``lr`` and ``t``.  Weights
and state keep their dtypes (state is made in the weight's dtype and
with its strides, as ``torch.zeros_like`` makes it); every intermediate
is f32 and each stored value is rounded once into its dtype, so a bf16
model is updated in bf16 storage without f32 copies of its weights.

``SGD``, ``NAG``, ``Adam`` and ``AdamW`` run on the multi-tensor CUDA
kernels of ``ops/optimizer_ops.py`` on the card (O2 for SGD and NAG, O1
for Adam and AdamW: one launch per group of tensors with the same
dtypes) and on their plain versions on the CPU, with one formula: ``lr``
(f32) and the update count (int32) are device scalars read by the
kernel, each tensor's ``lr_mult`` a factor of that ``lr``, and Adam's
``lr_t = lr*sqrt(1-b2^t)/(1-b1^t)`` is formed in f32 from the count cast
to f32, as the JAX package's jitted step forms it.  ``adamw`` is the JAX
package's rule, not ``torch.optim.AdamW``: ``w -= lr_t*m/(sqrt(v)+eps) +
lr*wd*w`` from the old ``w``.  The other optimizers are plain torch (the
JAX package runs them as XLA elementwise code); ``LAMB`` and ``LARS``
take their norms from O3.  ``lr`` and ``t`` may be numbers or 0-d
tensors on the weights' device everywhere.

A row-sparse gradient (``RowSparseNDArray``, from
``Embedding(sparse_grad=True)``) takes the lazy update
(``_lazy_update``; reference: optimizer_op.cc's sparse variants, the
JAX package's ``_get_sparse_jit_step``): only the rows present in the
compacted gradient move, in the weight and in every state tensor, each
by the optimizer's own step, so ``wd``, ``rescale_grad``,
``clip_gradient`` and the count ``t`` apply as in a dense step.  The
route is chosen by the optimizer's type alone (``_lazy_kernel``):
``SGD`` (with or without momentum), ``Adam`` and ``AdaGrad`` run O8 on
the card (``ops/sparse_ops.rsp_lazy_update``, one launch a parameter;
float32 only, it raises on any other dtype) and its plain version on
the CPU; every other optimizer gathers the rows, steps them and
scatters them back (the generic route).
"""
from __future__ import annotations

import pickle

import torch

from ..base import MXNetError
from ..ops import optimizer_ops as _ops
from ..ops import sparse_ops as _sparse_ops


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
            # the JAX package's rule: only base_lr is adopted
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

    def _lr_mult(self, index):
        """``param_dict[index].lr_mult`` first (a ``gluon.Trainer``'s
        Parameters), then ``lr_mult`` by index or name, as the JAX
        package's ``_get_lr`` reads them."""
        param = self.param_dict.get(index)
        if param is not None:
            return param.lr_mult
        return self._mult(self.lr_mult, index)

    def _wd_mult(self, index):
        param = self.param_dict.get(index)
        if param is not None:
            return param.wd_mult
        return self._mult(self.wd_mult, index)

    def _get_lr(self, index):
        return self.learning_rate * self._lr_mult(index)

    def _get_wd(self, index):
        return self.wd * self._wd_mult(index)

    # -- state --------------------------------------------------------------
    def create_state(self, index, weight):
        """Per-parameter state: None, a tensor or a tuple of tensors."""
        return None

    def create_state_multi_precision(self, index, weight):
        return self.create_state(index, weight)

    def _zeros(self, weight):
        """Zeros in the weight's dtype and with its strides (a
        channels-last conv weight's state is channels-last), as the
        multi-tensor kernels walk weight and state in one order."""
        return torch.zeros_like(_tensor(weight))

    def _clip(self):
        c = self.clip_gradient
        return -1.0 if c is None or c < 0 else float(c)

    def _grad32(self, grad, weight):
        """``clip(grad * rescale_grad)`` in f32, from the gradient rounded
        into the weight's dtype (as the kernels read it)."""
        g = grad.to(weight.dtype).float() * self.rescale_grad
        c = self._clip()
        return g.clamp(-c, c) if c >= 0 else g

    # -- the update -----------------------------------------------------------
    def _update(self, weight, grad, state, lr, wd, t):
        """Apply the formula to ``weight`` and ``state`` in place; ``lr``
        and ``t`` are 0-d f32 tensors on the weight's device."""
        raise NotImplementedError

    def _step(self, weight, grad, state, lr, wd, t):
        """Apply one update to ``weight`` and ``state`` in place; ``lr``
        and ``t`` are numbers or 0-d device tensors."""
        dev = weight.device
        with torch.no_grad():
            self._update(weight, grad, state, _ops._f32(lr, dev), float(wd),
                         _ops._f32(t, dev))
        return weight, state

    def _step_multi(self, weights, grads, states, lr, wds, t, lr_mults=None,
                    plain=False):
        """One update of every listed tensor, all at update count ``t``;
        tensor i's rate is ``lr * lr_mults[i]``.  ``plain`` (O8's plain
        version, for the optimizers with a lazy route) runs ``SGD`` and
        ``Adam`` through O2's and O1's plain versions on any device;
        ``AdaGrad`` is plain torch already."""
        for i, w in enumerate(weights):
            mult = 1.0 if lr_mults is None else lr_mults[i]
            self._step(w, grads[i], states[i], lr if mult == 1.0
                       else _ops._f32(lr, w.device) * mult, wds[i], t)

    # -- the lazy update of a row-sparse gradient ----------------------------
    def _lazy_kernel(self, state):
        """O8's route for this optimizer's rule (``ops/sparse_ops.ROUTES``)
        and its constants (keyword arguments of ``rsp_lazy_update``), or
        None: the generic route (gather, ``_step``, scatter)."""
        return None

    def _lazy_update(self, weight, grad, state, lr, wd, t, lr_mult=1.0):
        """Apply the row-sparse ``grad`` to the rows of ``weight`` (a
        tensor) and ``state`` it lists, in place; ``lr`` and ``t`` are
        numbers or 0-d device tensors (see the module docstring)."""
        rsp = grad.compact()
        dev = weight.device
        indices = rsp.indices._data.to(dev)
        values = rsp.values._data.to(dev)
        kernel = self._lazy_kernel(state)

        def step(w, g, s):
            # O8's plain version runs the step in plain torch
            self._step_multi([w], [g], [s], lr, [wd], t, [lr_mult],
                             plain=kernel is not None)

        if kernel is None:
            _sparse_ops.rsp_lazy_update_ref(weight, indices, values, state,
                                            step)
            return
        route, consts = kernel
        _sparse_ops.rsp_lazy_update(
            weight, indices, values, state, route, step,
            lr=_device_scalar(lr, torch.float32, dev),
            t=_device_scalar(t, torch.int32, dev), lr_mult=lr_mult, wd=wd,
            rescale=self.rescale_grad, clip=self._clip(), **consts)

    # -- imperative API (parity: Optimizer.update) ---------------------------
    def update(self, index, weight, grad, state):
        """One update of ``weight`` (an NDArray or a tensor) in place;
        returns ``(weight, state)``.  A ``RowSparseNDArray`` gradient
        takes the lazy update."""
        if isinstance(index, (list, tuple)):
            for i, w, g, s in zip(index, weight, grad, state):
                self.update(i, w, g, s)
            return None
        kind = type(grad).__name__
        if kind == "CSRNDArray":
            raise MXNetError("a csr gradient has no update: gradients are "
                             "dense or row_sparse")
        self._update_count(index)
        if kind == "RowSparseNDArray":
            self._lazy_update(_tensor(weight), grad, state,
                              self.learning_rate, self._get_wd(index),
                              self._index_update_count[index],
                              self._lr_mult(index))
        else:
            self._step(_tensor(weight), _tensor(grad), state,
                       self._get_lr(index), self._get_wd(index),
                       self._index_update_count[index])
        var = getattr(weight, "_var", None)
        if var is not None:
            var.on_write()
        return weight, state

    def update_multi_precision(self, index, weight, grad, state):
        return self.update(index, weight, grad, state)

    def __repr__(self):
        return "%s(lr=%s, wd=%s)" % (type(self).__name__,
                                     self.learning_rate, self.wd)


register = Optimizer.register


def create(name, **kwargs):
    return Optimizer.create_optimizer(name, **kwargs)


def _tensor(x):
    """The torch tensor of an NDArray, or the tensor itself."""
    return x.data() if hasattr(x, "_var") else x


def _device_scalar(x, dtype, device):
    """``x`` as a 0-d ``dtype`` tensor on ``device``: a number is written
    by a fill (no host copy, so a capture can record it); a tensor must
    already be there."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise MXNetError("a device scalar on %s for tensors on %s"
                             % (x.device, device))
        return x.reshape(()) if x.dtype == dtype else x.to(dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def _kernel_args(weights, lr, t, lr_mults):
    dev = weights[0].device
    mults = [1.0] * len(weights) if lr_mults is None else list(lr_mults)
    return (_device_scalar(lr, torch.float32, dev),
            _device_scalar(t, torch.int32, dev), mults)


def _pow(base, tf):
    """``base ** t`` in f32 (the JAX package's weak Python float raised to
    an f32 count)."""
    return torch.pow(_ops._f32(base, tf.device), tf)


# ---------------------------------------------------------------------------
# the optimizers on the multi-tensor kernels
# ---------------------------------------------------------------------------

@register
class SGD(Optimizer):
    """SGD with momentum (parity: optimizer.SGD; O2 on the card)."""

    _kind = _ops.SGD_MOMENTUM

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else self._zeros(weight)

    def _lazy_kernel(self, state):
        if self._kind != _ops.SGD_MOMENTUM:
            return None
        if self.momentum == 0.0 or state is None:
            return "sgd", {}
        return "sgd_mom", {"momentum": self.momentum}

    def _step(self, weight, grad, state, lr, wd, t):
        self._step_multi([weight], [grad], [state], lr, [wd], t)
        return weight, state

    def _step_multi(self, weights, grads, states, lr, wds, t, lr_mults=None,
                    plain=False):
        if not weights:
            return
        lr, _, mults = _kernel_args(weights, lr, t, lr_mults)
        bare = self.momentum == 0.0 or states[0] is None
        fn = _ops._multi_sgd_ref if plain else _ops.multi_sgd
        with torch.no_grad():
            fn(weights, grads, None if bare else list(states), mults,
               [float(w) for w in wds], lr=lr, momentum=self.momentum,
               kind=_ops.SGD_PLAIN if bare else self._kind,
               rescale_grad=float(self.rescale_grad),
               clip_gradient=self._clip())


@register
class NAG(SGD):
    """Nesterov SGD (parity: optimizer.NAG; O2 on the card)."""

    _kind = _ops.SGD_NESTEROV

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(momentum=momentum, **kwargs)


@register
class Adam(Optimizer):
    """Adam with bias correction; ``wd*w`` is folded into the clipped
    gradient (parity: optimizer.Adam; O1 on the card)."""

    _fold_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _lazy_kernel(self, state):
        if not self._fold_wd:
            return None
        return "adam", {"beta1": self.beta1, "beta2": self.beta2,
                        "eps": self.epsilon}

    def _step(self, weight, grad, state, lr, wd, t):
        self._step_multi([weight], [grad], [state], lr, [wd], t)
        return weight, state

    def _step_multi(self, weights, grads, states, lr, wds, t, lr_mults=None,
                    plain=False):
        if not weights:
            return
        lr, t, mults = _kernel_args(weights, lr, t, lr_mults)
        fn = _ops._multi_adamw_ref if plain else _ops.multi_adamw
        with torch.no_grad():
            fn(weights, grads, [s[0] for s in states], [s[1] for s in states],
               mults, [float(w) for w in wds], lr=lr, t=t, beta1=self.beta1,
               beta2=self.beta2, epsilon=self.epsilon,
               rescale_grad=float(self.rescale_grad),
               clip_gradient=self._clip(), fold_wd=self._fold_wd)

    def _adam_step(self, weight, mean, var, lr, t, decay=0.0, wd=0.0):
        """The weight rule alone, given updated moments (plain torch, for
        the tests): ``w -= lr_t*m/(sqrt(v)+eps) + decay*w`` from the old
        ``w``, summed in f32 and rounded into ``w`` once, with ``lr_t``
        formed in f32 and ``sqrt(v)+eps`` in the state's dtype, as O1
        forms them.  ``wd`` is accepted for the old
        signature and unused: ``decay`` is ``lr*wd``."""
        if weight.device.type != "cpu":
            raise MXNetError("_adam_step is the plain weight rule, for CPU "
                             "tensors; the card's update is O1 "
                             "(_step_multi)")
        dev = weight.device
        lr, tf = _ops._f32(lr, dev), _ops._f32(t, dev)
        a = lr * torch.sqrt(1.0 - _pow(self.beta2, tf)) \
            / (1.0 - _pow(self.beta1, tf))
        w = weight.float()
        den = (torch.sqrt(var.float()).to(var.dtype).float()
               + _ops._f32(self.epsilon, dev)).to(var.dtype).float()
        with torch.no_grad():
            weight.copy_(w - (a * mean.float() / den
                              + _ops._f32(decay, dev) * w))


@register
class AdamW(Adam):
    """Decoupled weight decay Adam (parity: contrib adamw_update; O1 on
    the card)."""

    _fold_wd = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)


# ---------------------------------------------------------------------------
# the optimizers in plain torch (f32 intermediates, one rounding a store)
# ---------------------------------------------------------------------------

@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (parity: optimizer.SGLD).

    The noise comes from a generator per device, seeded from torch's
    initial seed: torch's Philox bits differ from the JAX package's
    threefry keys, so the two compare by moments only."""

    def create_state(self, index, weight):
        return None

    def _generator(self, device):
        gens = self.__dict__.setdefault("_generators", {})
        gen = gens.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(torch.initial_seed() % (2 ** 63))
            gens[device] = gen
        return gen

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_generators", None)
        return d

    def _update(self, weight, grad, state, lr, wd, t):
        w = weight.float()
        g = self._grad32(grad, weight) + wd * w
        noise = torch.randn(weight.shape, dtype=torch.float32,
                            device=weight.device,
                            generator=self._generator(weight.device))
        weight.copy_(w - 0.5 * lr * g + noise * torch.sqrt(lr))


@register
class Adamax(Optimizer):
    """AdaMax, Adam on the infinity norm (parity: optimizer.Adamax)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _update(self, weight, grad, state, lr, wd, t):
        mean, u = state
        w = weight.float()
        g = self._grad32(grad, weight) + wd * w
        m = self.beta1 * mean.float() + (1 - self.beta1) * g
        un = torch.maximum(self.beta2 * u.float(), g.abs())
        lr_t = lr / (1.0 - _pow(self.beta1, t))
        weight.copy_(w - lr_t * m / torch.clamp(un, min=1e-30))
        mean.copy_(m)
        u.copy_(un)


@register
class LBSGD(Optimizer):
    """Large-batch SGD: momentum SGD with a warmup multiplier of the rate
    or LARS scaling (parity: optimizer.LBSGD, and its deviation: every
    update is one macro-batch step)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = float(batch_scale)
        self.updates_per_epoch = updates_per_epoch

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else self._zeros(weight)

    def _warmup_mult(self, t):
        nwup = float(self.warmup_epochs * self.updates_per_epoch)
        maxmult = self.batch_scale
        if nwup <= 1 or maxmult <= 1 \
                or self.warmup_strategy not in ("linear", "power2", "sqrt"):
            return _ops._f32(1.0, t.device)
        frac = torch.clamp(t / nwup, max=1.0)
        if self.warmup_strategy == "power2":
            frac = frac * frac
        elif self.warmup_strategy == "sqrt":
            frac = torch.sqrt(frac)
        return 1.0 + (maxmult - 1.0) * frac

    def _update(self, weight, grad, state, lr, wd, t):
        w = weight.float()
        g = self._grad32(grad, weight) + wd * w
        if self.warmup_strategy == "lars":
            w2 = w.square().sum()
            g2 = g.square().sum()
            lars = torch.sqrt(w2 / (g2 + wd * w2 + 1e-18))
            lr = lr * torch.clamp(lars, 0.01, 100.0)
        else:
            lr = lr * self._warmup_mult(t)
        if self.momentum == 0.0 or state is None:
            weight.copy_(w - lr * g)
            return
        mom = self.momentum * state.float() - lr * g
        weight.copy_(w + mom)
        state.copy_(mom)


@register
class AdaGrad(Optimizer):
    """Parity: optimizer.AdaGrad."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return self._zeros(weight)

    def _lazy_kernel(self, state):
        return "adagrad", {"eps": self.float_stable_eps}

    def _update(self, weight, grad, state, lr, wd, t):
        w = weight.float()
        g = self._grad32(grad, weight) + wd * w
        hist = state.float() + g.square()
        weight.copy_(w - lr * g / torch.sqrt(hist + self.float_stable_eps))
        state.copy_(hist)


@register
class AdaDelta(Optimizer):
    """Parity: optimizer.AdaDelta."""

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _update(self, weight, grad, state, lr, wd, t):
        acc_g, acc_delta = state
        w = weight.float()
        g = self._grad32(grad, weight) + wd * w
        ag = self.rho * acc_g.float() + (1 - self.rho) * g.square()
        delta = torch.sqrt(acc_delta.float() + self.epsilon) \
            / torch.sqrt(ag + self.epsilon) * g
        ad = self.rho * acc_delta.float() + (1 - self.rho) * delta.square()
        weight.copy_(w - delta)
        acc_g.copy_(ag)
        acc_delta.copy_(ad)


@register
class RMSProp(Optimizer):
    """Parity: optimizer.RMSProp (``centered=True`` is Graves' variant)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (self._zeros(weight), self._zeros(weight),
                    self._zeros(weight))    # n, g_mean, delta
        return (self._zeros(weight),)

    def _update(self, weight, grad, state, lr, wd, t):
        w = weight.float()
        g = self._grad32(grad, weight) + wd * w
        n = (1 - self.gamma1) * g.square() + self.gamma1 * state[0].float()
        if self.centered:
            g_mean = (1 - self.gamma1) * g + self.gamma1 * state[1].float()
            delta = self.gamma2 * state[2].float() - lr * g / torch.sqrt(
                n - g_mean.square() + self.epsilon)
            new = w + delta
            state[1].copy_(g_mean)
            state[2].copy_(delta)
        else:
            new = w - lr * g / (torch.sqrt(n) + self.epsilon)
        state[0].copy_(n)
        if self.clip_weights:
            new = new.clamp(-self.clip_weights, self.clip_weights)
        weight.copy_(new)


@register
class Ftrl(Optimizer):
    """Parity: optimizer.Ftrl (op ftrl_update)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _update(self, weight, grad, state, lr, wd, t):
        z, n = state
        w = weight.float()
        g = self._grad32(grad, weight)
        n_old = n.float()
        sigma = (torch.sqrt(n_old + g.square()) - torch.sqrt(n_old)) / lr
        zn = z.float() + g - sigma * w
        nn = n_old + g.square()
        weight.copy_(torch.where(
            zn.abs() > self.lamda1,
            -(zn - torch.sign(zn) * self.lamda1)
            / ((self.beta + torch.sqrt(nn)) / lr + wd),
            torch.zeros_like(w)))
        z.copy_(zn)
        n.copy_(nn)


@register
class Signum(Optimizer):
    """Parity: optimizer.Signum (signSGD with momentum)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else self._zeros(weight)

    def _update(self, weight, grad, state, lr, wd, t):
        w = weight.float()
        g = self._grad32(grad, weight)
        if self.momentum == 0.0 or state is None:
            weight.copy_(w * (1 - lr * self.wd_lh)
                         - lr * torch.sign(g + wd * w))
            return
        mom = self.momentum * state.float() - (1 - self.momentum) \
            * (g + wd * w)
        weight.copy_(w * (1 - lr * self.wd_lh) + lr * torch.sign(mom))
        state.copy_(mom)


@register
class FTML(Optimizer):
    """Parity: optimizer.FTML."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight),
                self._zeros(weight))    # d, v, z

    def _update(self, weight, grad, state, lr, wd, t):
        d, v, z = state
        w = weight.float()
        g = self._grad32(grad, weight) + wd * w
        vn = self.beta2 * v.float() + (1 - self.beta2) * g.square()
        d_t = (1 - _pow(self.beta1, t)) / lr * (
            torch.sqrt(vn / (1 - _pow(self.beta2, t))) + self.epsilon)
        sigma = d_t - self.beta1 * d.float()
        zn = self.beta1 * z.float() + (1 - self.beta1) * g - sigma * w
        weight.copy_(-zn / d_t)
        d.copy_(d_t)
        v.copy_(vn)
        z.copy_(zn)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (parity: optimizer.DCASGD)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (self._zeros(w), w.detach().clone(
            memory_format=torch.preserve_format))  # mom, previous weight

    def _update(self, weight, grad, state, lr, wd, t):
        mom, prev = state
        w = weight.float()
        g = self._grad32(grad, weight) + wd * w
        comp = g + self.lamda * g * g * (w - prev.float())
        mn = self.momentum * mom.float() - lr * comp
        new = w + mn        # before the copies: an f32 w is the weight
        weight.copy_(new)
        mom.copy_(mn)
        prev.copy_(new)


@register
class Nadam(Optimizer):
    """Parity: optimizer.Nadam (its ``m_schedule`` a 0-d f32 state)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (self._zeros(w), self._zeros(w),
                torch.ones((), dtype=torch.float32, device=w.device))

    def _update(self, weight, grad, state, lr, wd, t):
        m, v, m_sched = state
        w = weight.float()
        g = self._grad32(grad, weight) + wd * w
        mu_t = self.beta1 * (1 - 0.5 * _pow(0.96, t * self.schedule_decay))
        mu_tp1 = self.beta1 * (1 - 0.5 * _pow(
            0.96, (t + 1) * self.schedule_decay))
        ms_t = m_sched * mu_t
        ms_tp1 = ms_t * mu_tp1
        g_prime = g / (1 - ms_t)
        mn = self.beta1 * m.float() + (1 - self.beta1) * g
        m_prime = mn / (1 - ms_tp1)
        vn = self.beta2 * v.float() + (1 - self.beta2) * g.square()
        v_prime = vn / (1 - _pow(self.beta2, t))
        m_bar = (1 - mu_t) * g_prime + mu_tp1 * m_prime
        weight.copy_(w - lr * m_bar / (torch.sqrt(v_prime) + self.epsilon))
        m.copy_(mn)
        v.copy_(vn)
        m_sched.copy_(ms_t)


def _norms(*tensors):
    """The f32 L2 norm of each tensor, from one O3 read."""
    sums, _ = _ops.multi_sum_sq(list(tensors))
    return sums.sqrt().unbind(0)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (parity: optimizer.LAMB; its norms
    from O3)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _update(self, weight, grad, state, lr, wd, t):
        mean, var = state
        w = weight.float()
        g = self._grad32(grad, weight)
        m = self.beta1 * mean.float() + (1 - self.beta1) * g
        v = self.beta2 * var.float() + (1 - self.beta2) * g.square()
        mean.copy_(m)
        var.copy_(v)
        if self.bias_correction:
            m = m / (1 - _pow(self.beta1, t))
            v = v / (1 - _pow(self.beta2, t))
        upd = m / (torch.sqrt(v) + self.epsilon) + wd * w
        w_norm, u_norm = _norms(weight, upd)
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        if self.lower_bound is not None:
            ratio = torch.clamp(ratio, min=self.lower_bound)
        if self.upper_bound is not None:
            ratio = torch.clamp(ratio, max=self.upper_bound)
        weight.copy_(w - lr * ratio * upd)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (parity: optimizer.LARS; its
    norms from O3)."""

    def __init__(self, momentum=0.9, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return self._zeros(weight)

    def _update(self, weight, grad, state, lr, wd, t):
        w = weight.float()
        g = self._grad32(grad, weight)
        w_norm, g_norm = _norms(weight, g)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon),
            torch.ones_like(w_norm))
        g = g + wd * w
        mom = self.momentum * state.float() + lr * trust * g
        weight.copy_(w - mom)
        state.copy_(mom)


@register
class Test(Optimizer):
    """Trivial optimizer used by unit tests (parity: optimizer.Test)."""

    def create_state(self, index, weight):
        return self._zeros(weight)

    def _update(self, weight, grad, state, lr, wd, t):
        weight.copy_(weight.float() + grad.float() * self.rescale_grad)


# ---------------------------------------------------------------------------
# Updater (parity: optimizer.Updater / get_updater)
# ---------------------------------------------------------------------------

def _to_numpy(state):
    """A state as numpy copies (bf16 as f32), None as None."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_to_numpy(s) for s in state)
    t = state.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy() \
        .copy()


def _from_numpy(state, like):
    """Numpy state back into tensors beside the weight ``like``: the
    weight's dtype and strides where the shape is the weight's."""
    if state is None or isinstance(state, torch.Tensor):
        return state
    if isinstance(state, (tuple, list)):
        return type(state)(_from_numpy(s, like) for s in state)
    host = torch.from_numpy(state)
    if tuple(host.shape) == tuple(like.shape):
        return torch.empty_like(like).copy_(host)
    return host.to(like.device)


class Updater:
    """Applies an optimizer keyed by integer index (the kvstore server's
    form; parity: optimizer.Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        w = _tensor(weight)
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, w)
        else:
            self.states[index] = _from_numpy(self.states[index], w)
        self.optimizer.update(index, weight, grad, self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states as a pickle of numpy copies (and the optimizer)."""
        states = {k: _to_numpy(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states):
        """States from ``get_states``; they become tensors beside their
        weights at the next update."""
        loaded = pickle.loads(states)
        if isinstance(loaded, tuple):
            self.states, self.optimizer = loaded
        else:
            self.states = loaded


def get_updater(optimizer):
    return Updater(optimizer)

