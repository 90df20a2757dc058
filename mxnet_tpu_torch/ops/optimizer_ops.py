"""Optimizer update ops: the multi-tensor kernels O1-O3 and the update ops
of the registry (the port's counterpart of ``mxnet_tpu/ops/optimizer_ops.py``).

Three hand-written CUDA C++ kernels (``csrc/optimizer_ops.cu``, built by
``ops/_build.py`` at first use) run the updates of the train paths, each
over a list of tensors in one launch:

- O1 ``multi_adamw``: Adam and AdamW, the class forms (``lr`` and the
  update count read on the card, ``lr_t = lr*sqrt(1-b2^t)/(1-b1^t)``)
  and the op forms (``lr``, ``eta`` and ``wd`` as given, no bias
  correction);
- O2 ``multi_sgd``: plain, momentum and Nesterov SGD;
- O3 ``multi_sum_sq``: each tensor's f32 sum of squares and one
  all-finite flag, in one read and in a fixed order.

Both O1 and O2 take f32 master weights (the ``mp_`` forms).  Every
intermediate is f32, and each stored value is rounded once into its
dtype; outside the ``mp_`` forms the gradient is first rounded into the
weight's dtype.  Beside each kernel stands its plain PyTorch version
(``_multi_adamw_ref``, ``_multi_sgd_ref``, ``_multi_sum_sq_ref``), one
op at a time in the kernel's order.  The wrapper runs it for CPU
tensors only; a CUDA tensor launches the kernel or raises.  Weights,
gradients and states must be dense with equal strides (a channels-last
weight's state is made channels-last); the wrapper raises where they are
not and never copies.  ``multi_adamw.launches``, ``multi_sgd.launches``
and ``multi_sum_sq.launches`` count kernel launches (``graph_cache.count``:
replays of a captured graph included).

The registered ops write the weights and states they are given in place
(the port's arrays are mutable, as the reference's are; the JAX package
returns new arrays instead) and return what the JAX package's ops
return.  ``_sparse_adagrad_update`` needs row-sparse arrays, slice S7 of
the port, and raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import graph_cache as _graph_cache
from ..base import MXNetError
from . import _build
from .registry import register

_SOURCE = _build.source_path("optimizer_ops.cu")
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SGD_PLAIN, SGD_MOMENTUM, SGD_NESTEROV = 0, 1, 2


# -- plain versions -----------------------------------------------------------

def _f32(x, device):
    """``x`` (a number or a tensor) as a 0-d f32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _grad_in(g, weight, mp, rescale, clip):
    """The gradient as both kernels read it: rounded into the weight's
    dtype outside the mp_ forms, times ``rescale``, clipped."""
    g = g.float() if mp else g.to(weight.dtype).float()
    g = g * rescale
    return g.clamp(-clip, clip) if clip >= 0 else g


def _multi_adamw_ref(weights, grads, means, variances, lrs, wds, lr=None,
                     t=None, etas=None, beta1=0.9, beta2=0.999, epsilon=1e-8,
                     rescale_grad=1.0, clip_gradient=-1.0, fold_wd=False,
                     weights32=None):
    """What O1 computes, in place, one op at a time in the kernel's
    order (see ``multi_adamw``)."""
    if not weights:
        return
    dev = weights[0].device
    b1, b2, eps = (_f32(x, dev) for x in (beta1, beta2, epsilon))
    omb1, omb2 = _f32(1.0 - beta1, dev), _f32(1.0 - beta2, dev)
    rescale = _f32(rescale_grad, dev)
    mp = weights32 is not None
    if t is not None:
        tf = _f32(t, dev)
        c2 = 1.0 - torch.pow(b2, tf)
        c1 = 1.0 - torch.pow(b1, tf)
    for i, w in enumerate(weights):
        lr_i = _f32(lrs[i], dev)
        if lr is not None:
            lr_i = _f32(lr, dev) * lr_i
        wd = _f32(wds[i], dev)
        eta = _f32(1.0 if etas is None else etas[i], dev)
        if t is not None:
            a = lr_i * torch.sqrt(c2) / c1
            d = _f32(0.0, dev) if fold_wd else lr_i * wd
        else:
            a, d = lr_i, (_f32(0.0, dev) if fold_wd else wd)
        wv = weights32[i] if mp else w.float()
        g = _grad_in(grads[i], w, mp, rescale, clip_gradient)
        if fold_wd:
            g = g + wd * wv
        m, v = means[i], variances[i]
        m.copy_(b1 * m.float() + omb1 * g)
        v.copy_(b2 * v.float() + omb2 * (g * g))
        # sqrt(v) + eps in the state's dtype, each op rounded there
        den = (torch.sqrt(v.float()).to(v.dtype).float() + eps) \
            .to(v.dtype).float()
        new = wv - eta * (a * m.float() / den + d * wv)
        if mp:
            weights32[i].copy_(new)
        w.copy_(new)


def _multi_sgd_ref(weights, grads, moms, lrs, wds, lr=None, dev_lrs=None,
                   dev_wds=None, momentum=0.0, kind=SGD_PLAIN,
                   rescale_grad=1.0, clip_gradient=-1.0, weights32=None):
    """What O2 computes, in place (see ``multi_sgd``).  Each ``a*x + y``
    is ``torch.add(y, x, alpha=a)``, one fused multiply-add, as O2 and
    the JAX package's XLA step form it; the f32 rates are read to the
    host for ``alpha``."""
    if not weights:
        return
    dev = weights[0].device
    mu, rescale = _f32(momentum, dev), _f32(rescale_grad, dev)
    mp = weights32 is not None
    for i, w in enumerate(weights):
        lr_i = dev_lrs[i] if dev_lrs is not None else _f32(lrs[i], dev)
        if lr is not None:
            lr_i = _f32(lr, dev) * lr_i
        wd = dev_wds[i] if dev_wds is not None else _f32(wds[i], dev)
        neg_lr, wd, m = -lr_i.item(), wd.item(), mu.item()
        wv = weights32[i] if mp else w.float()
        g = _grad_in(grads[i], w, mp, rescale, clip_gradient)
        gd = torch.add(g, wv, alpha=wd)
        if kind == SGD_PLAIN:
            new = torch.add(wv, gd, alpha=neg_lr)
        elif kind == SGD_MOMENTUM:
            nm = torch.add(mu * moms[i].float(), gd, alpha=neg_lr)
            new = wv + nm
            moms[i].copy_(nm)
        else:
            nm = torch.add(gd, moms[i].float(), alpha=m)
            new = torch.add(wv, torch.add(gd, nm, alpha=m), alpha=neg_lr)
            moms[i].copy_(nm)
        if mp:
            weights32[i].copy_(new)
        w.copy_(new)


def _multi_sum_sq_ref(arrays):
    """What O3 computes: ``(sums, flag)``, each tensor's sum of squares
    (taken in f64, rounded to f32) and 1.0 if every element of every
    tensor is finite, else 0.0 (f32, shape (1,))."""
    dev = arrays[0].device if arrays else torch.device("cpu")
    sums = torch.stack([a.double().square().sum().float() for a in arrays]) \
        if arrays else torch.zeros(0, device=dev)
    ok = all(bool(torch.isfinite(a).all()) for a in arrays)
    return sums, torch.full((1,), 1.0 if ok else 0.0, device=dev)


# -- the kernels --------------------------------------------------------------

def library_path(defines=()):
    """Where the built kernel library lives (``build/`` at the repo root,
    named by a hash of the source and flags)."""
    return _build.library_path(_SOURCE, defines)


def build(verbose=False):
    """Compile ``csrc/optimizer_ops.cu`` with nvcc (when its library is
    not built yet) and return its path."""
    return _build.build(_SOURCE, verbose=verbose)


def _bind(lib):
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    n_out = ctypes.POINTER(i)     # each entry point's last: kernels launched
    # n; w, g, m, v, w32, numel, lrs, wds, etas; lr, t, rescale_p;
    # rescale, clip, beta1, beta2, 1-beta1, 1-beta2, eps; fold_wd, wtype,
    # gtype, stype, mp; stream, launched
    lib.mxtt_multi_adamw.argtypes = [i] + [p] * 9 + [p] * 3 + [f] * 7 \
        + [i] * 5 + [p, n_out]
    # n; w, g, mom, w32, numel, lrs, wds; lr, dev_lrs, dev_wds; rescale,
    # clip, momentum; kind, wtype, gtype, stype, mp; stream, launched
    lib.mxtt_multi_sgd.argtypes = [i] + [p] * 7 + [p] * 3 + [f] * 3 \
        + [i] * 5 + [p, n_out]
    lib.mxtt_multi_sum_sq.argtypes = [i, p, p, p, p, p, p, ll, p, n_out]
    for fn in (lib.mxtt_multi_adamw, lib.mxtt_multi_sgd,
               lib.mxtt_multi_sum_sq, lib.mxtt_optimizer_chunk):
        fn.restype = i
    lib.mxtt_optimizer_chunk.argtypes = []
    lib.mxtt_optimizer_error_string.argtypes = [i]
    lib.mxtt_optimizer_error_string.restype = ctypes.c_char_p


def _load():
    return _build.load(_SOURCE, _bind)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _floats(xs):
    return (ctypes.c_float * len(xs))(*[float(x) for x in xs])


def _numels(ts):
    return (ctypes.c_longlong * len(ts))(*[t.numel() for t in ts])


def _scalar_ptr(x, dtype, dev, what):
    """The device address of a 0-d (or 1-element) ``dtype`` tensor."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor) or x.device != dev \
            or x.dtype != dtype or x.numel() != 1:
        raise MXNetError("%s must be a one-element %s tensor on %s, got %r"
                         % (what, dtype, dev, x))
    return x.data_ptr()


def _on_card(tensors, what):
    dev = tensors[0].device
    if dev.type not in ("cuda", "cpu"):
        raise MXNetError("%s runs on cuda or cpu tensors, got %s"
                         % (what, dev))
    return dev.type == "cuda"


def _sized_strides(t):
    return tuple(s for s, n in zip(t.stride(), t.shape) if n > 1)


def _dense(t):
    """True when ``t`` covers one gap-free block of memory, each element
    once, in whatever dim order (contiguous, channels-last, ...)."""
    expect = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape)
                               if n > 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _check_like(what, name, i, ref, t):
    """``t`` beside the weight ``ref``: same shape, device and float dtype,
    dense, and the same element order (strides equal over the dims longer
    than 1), since the kernels walk memory linearly."""
    if t.dtype not in _CODES:
        raise MXNetError("%s: %s %d is %s" % (what, name, i, t.dtype))
    if t.shape != ref.shape or t.device != ref.device:
        raise MXNetError("%s: %s %d is %s on %s, its weight %s on %s"
                         % (what, name, i, tuple(t.shape), t.device,
                            tuple(ref.shape), ref.device))
    if ref.is_contiguous() and t.is_contiguous():
        return          # the common case, without a stride walk
    if not _dense(t) or _sized_strides(t) != _sized_strides(ref):
        raise MXNetError(
            "%s: %s %d has strides %s, its weight %s; the update walks "
            "memory linearly and copies nothing, so states and gradients "
            "must be dense with the weight's strides (make state with "
            "torch.zeros_like(weight))"
            % (what, name, i, t.stride(), ref.stride()))


def _check_lists(what, weights, named):
    dev = weights[0].device
    for i, w in enumerate(weights):
        if w.dtype not in _CODES:
            raise MXNetError("%s takes float32, bfloat16 or float16 weights,"
                             " got %s" % (what, w.dtype))
        if w.device != dev:
            raise MXNetError("%s: weight %d is on %s, weight 0 on %s"
                             % (what, i, w.device, dev))
        if not w.is_contiguous() and not _dense(w):
            raise MXNetError("%s: weight %d is not dense (strides %s)"
                             % (what, i, w.stride()))
        for name, ts in named:
            if ts is not None:
                _check_like(what, name, i, w, ts[i])


def _state_code(what, w, s):
    if s.dtype != w.dtype and s.dtype != torch.float32:
        raise MXNetError("%s: state %s beside a %s weight (states are the "
                         "weight's dtype or float32)" % (what, s.dtype,
                                                         w.dtype))
    return _CODES[s.dtype]


def _groups(keys):
    """Indices grouped by key, in first-seen order."""
    out = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return list(out.items())


def _launch(lib, owner, entry, *args):
    """Call the library's ``entry`` with ``args``, count the kernels it
    launched on ``owner.launches`` and raise if it failed."""
    launched = ctypes.c_int(0)
    err = entry(*args, ctypes.byref(launched))
    _graph_cache.count(owner, "launches", launched.value)
    if err != 0:
        raise MXNetError("%s launch failed: %s (%d)" % (
            owner.__name__, lib.mxtt_optimizer_error_string(err).decode(),
            err))


def multi_adamw(weights, grads, means, variances, lrs, wds, lr=None, t=None,
                etas=None, beta1=0.9, beta2=0.999, epsilon=1e-8,
                rescale_grad=1.0, clip_gradient=-1.0, fold_wd=False,
                weights32=None):
    """O1: one Adam/AdamW update of every listed tensor, in place.

    Per tensor i, from f32 values (``w`` the master weight in the mp_
    forms): ``g = clip(g*rescale_grad)``, ``g += wd*w`` when ``fold_wd``
    (Adam), ``m = b1*m + (1-b1)*g`` and ``v = b2*v + (1-b2)*g^2`` (each
    rounded into its stored dtype), then
    ``w -= eta*(a*m/(sqrt(v)+eps) + d*w)`` from the stored ``m`` and
    ``v``, with ``sqrt(v)+eps`` formed in the state's dtype (as the JAX
    package forms it; exact in f32).  Class forms (``lr`` and
    ``t`` 0-d f32 and int32 tensors on the weights' device): ``lrs`` are
    per-tensor factors of ``lr``, ``a = lr_i*sqrt(1-b2^t)/(1-b1^t)``,
    ``d = lr_i*wd`` (0 with ``fold_wd``) and ``eta`` 1.  Op forms (``lr``
    and ``t`` None): ``a = lrs[i]``, ``d = wds[i]`` and ``eta = etas[i]``.
    ``rescale_grad`` is a number or a one-element f32 device tensor;
    ``clip_gradient < 0`` means no clipping.  On the card, one launch per
    group of tensors with the same dtypes (and per table of 448).
    """
    n = len(weights)
    if not n:
        return
    named = [("gradient", grads), ("mean", means), ("var", variances),
             ("master weight", weights32)]
    _check_lists("multi_adamw", weights, named)
    if not _on_card(weights, "multi_adamw"):
        _multi_adamw_ref(weights, grads, means, variances, lrs, wds, lr=lr,
                         t=t, etas=etas, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient, fold_wd=fold_wd,
                         weights32=weights32)
        return
    dev = weights[0].device
    if (lr is None) != (t is None):
        raise MXNetError("multi_adamw: lr and t are both device scalars (the "
                         "class forms) or both None (the op forms)")
    lr_p = _scalar_ptr(lr, torch.float32, dev, "lr")
    t_p = _scalar_ptr(t, torch.int32, dev, "t")
    if isinstance(rescale_grad, torch.Tensor):
        rescale_p = _scalar_ptr(rescale_grad, torch.float32, dev,
                                "rescale_grad")
        rescale = 1.0
    else:
        rescale_p, rescale = None, float(rescale_grad)
    mp = weights32 is not None
    if mp and any(x.dtype != torch.float32 for x in
                  list(weights32) + list(means) + list(variances)):
        raise MXNetError("multi_adamw: the mp_ forms keep f32 master "
                         "weights and states")
    etas = [1.0] * n if etas is None else etas
    keys = [(weights[i].dtype, grads[i].dtype,
             _state_code("multi_adamw", weights[i], means[i]),
             _state_code("multi_adamw", weights[i], variances[i]))
            for i in range(n)]
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for (wt, gt, mt, vt), idx in _groups(keys):
            if mt != vt:
                raise MXNetError("multi_adamw: mean and var of one weight "
                                 "differ in dtype")
            pick = (lambda xs: [xs[i] for i in idx])
            ws = pick(weights)
            _launch(
                lib, multi_adamw, lib.mxtt_multi_adamw, len(idx), _ptrs(ws),
                _ptrs(pick(grads)), _ptrs(pick(means)),
                _ptrs(pick(variances)),
                _ptrs(pick(weights32)) if mp else None, _numels(ws),
                _floats(pick(lrs)), _floats(pick(wds)), _floats(pick(etas)),
                lr_p, t_p, rescale_p, rescale, float(clip_gradient),
                float(beta1), float(beta2), float(1.0 - beta1),
                float(1.0 - beta2), float(epsilon), int(bool(fold_wd)),
                _CODES[wt], _CODES[gt], mt, int(mp), stream)


def multi_sgd(weights, grads, moms, lrs, wds, lr=None, dev_lrs=None,
              dev_wds=None, momentum=0.0, kind=SGD_PLAIN, rescale_grad=1.0,
              clip_gradient=-1.0, weights32=None):
    """O2: one SGD update of every listed tensor, in place.

    Per tensor i, from f32 values: ``g = clip(g*rescale_grad) + wd*w``;
    plain ``w -= lr*g``; momentum ``mom = mu*mom - lr*g; w += mom``;
    Nesterov ``mom = mu*mom + g; w -= lr*(g + mu*mom)``, each ``a*x + y``
    one fused multiply-add.  ``lr``, when
    given, is a 0-d f32 device tensor whose per-tensor factors are
    ``lrs``; ``dev_lrs``/``dev_wds`` are f32 device arrays of one rate
    and one decay a tensor (the preloaded_ ops; they replace ``lrs`` and
    ``wds``).  ``moms`` is None for plain SGD.
    """
    n = len(weights)
    if not n:
        return
    if (kind == SGD_PLAIN) != (moms is None):
        raise MXNetError("multi_sgd: momentum states go with the momentum "
                         "kinds only")
    _check_lists("multi_sgd", weights, [("gradient", grads),
                                        ("momentum", moms),
                                        ("master weight", weights32)])
    if not _on_card(weights, "multi_sgd"):
        _multi_sgd_ref(weights, grads, moms, lrs, wds, lr=lr,
                       dev_lrs=dev_lrs, dev_wds=dev_wds, momentum=momentum,
                       kind=kind, rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient, weights32=weights32)
        return
    dev = weights[0].device
    lr_p = _scalar_ptr(lr, torch.float32, dev, "lr")
    for name, arr in (("lrs", dev_lrs), ("wds", dev_wds)):
        if arr is not None and (arr.device != dev or arr.dtype !=
                                torch.float32 or arr.numel() != n
                                or not arr.is_contiguous()):
            raise MXNetError("multi_sgd: %s must be a contiguous f32 array "
                             "of %d on %s" % (name, n, dev))
    mp = weights32 is not None
    if mp and (any(x.dtype != torch.float32 for x in weights32) or (
            moms is not None and any(m.dtype != torch.float32
                                     for m in moms))):
        raise MXNetError("multi_sgd: the mp_ forms keep f32 master weights "
                         "and states")
    lrs = [1.0] * n if lrs is None else lrs
    wds = [0.0] * n if wds is None else wds
    # without momentum there is no state: its code only picks a kernel
    keys = [(weights[i].dtype, grads[i].dtype,
             _state_code("multi_sgd", weights[i], moms[i])
             if moms is not None else _CODES[torch.float32 if mp
                                             else weights[i].dtype])
            for i in range(n)]
    groups = _groups(keys)
    if (dev_lrs is not None or dev_wds is not None) and len(groups) > 1:
        raise MXNetError("multi_sgd: preloaded rates need one dtype across "
                         "the list")
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for (wt, gt, st), idx in groups:
            pick = (lambda xs: [xs[i] for i in idx])
            ws = pick(weights)
            _launch(
                lib, multi_sgd, lib.mxtt_multi_sgd, len(idx), _ptrs(ws),
                _ptrs(pick(grads)),
                _ptrs(pick(moms)) if moms is not None else None,
                _ptrs(pick(weights32)) if mp else None, _numels(ws),
                _floats(pick(lrs)), _floats(pick(wds)), lr_p,
                dev_lrs.data_ptr() if dev_lrs is not None else None,
                dev_wds.data_ptr() if dev_wds is not None else None,
                float(rescale_grad), float(clip_gradient), float(momentum),
                int(kind), _CODES[wt], _CODES[gt], st, int(mp), stream)


def multi_sum_sq(arrays):
    """O3: ``(sums, flag)`` over a list of float tensors in one read: each
    tensor's sum of squares (f32, taken in f64 in a fixed order) and
    1.0 if every element of every tensor is finite, else 0.0 (f32,
    shape (1,)).  Deterministic: no float atomics.  On the card each
    tensor must be dense (in any dim order); CPU tensors may have any
    strides."""
    arrays = list(arrays)
    if not arrays:
        return _multi_sum_sq_ref(arrays)
    for i, a in enumerate(arrays):
        if a.dtype not in _CODES:
            raise MXNetError("multi_sum_sq takes float tensors, got %s"
                             % a.dtype)
        if a.device != arrays[0].device:
            raise MXNetError("multi_sum_sq: array %d is on %s, array 0 on %s"
                             % (i, a.device, arrays[0].device))
    if not _on_card(arrays, "multi_sum_sq"):
        return _multi_sum_sq_ref(arrays)
    for i, a in enumerate(arrays):
        if not _dense(a):
            raise MXNetError(
                "multi_sum_sq: array %d is not dense (strides %s); on the "
                "card O3 reads each tensor as one block of memory and copies "
                "nothing (amp's overflow check, clip_global_norm, LAMB and "
                "LARS read their gradients and weights through it)"
                % (i, a.stride()))
    dev = arrays[0].device
    lib = _load()
    chunk = lib.mxtt_optimizer_chunk()
    total = sum(-(-a.numel() // chunk) for a in arrays)
    sums = torch.empty(len(arrays), dtype=torch.float32, device=dev)
    flag = torch.empty(1, dtype=torch.float32, device=dev)
    work = torch.empty(max(total, 1) * 12, dtype=torch.uint8, device=dev)
    codes = (ctypes.c_int * len(arrays))(*[_CODES[a.dtype] for a in arrays])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib, multi_sum_sq, lib.mxtt_multi_sum_sq, len(arrays),
                _ptrs(arrays), _numels(arrays), codes, sums.data_ptr(),
                flag.data_ptr(), work.data_ptr(), total, stream)
    return sums, flag


multi_adamw.launches = 0
multi_sgd.launches = 0
multi_sum_sq.launches = 0


# -- registered ops -----------------------------------------------------------
# Each writes its weight and state inputs in place and returns the JAX
# package's outputs (``inplace=True``: never deferred into a bulk segment).

def _clip_arg(c):
    return -1.0 if c is None else float(c)


def _sgd_op(weight, grad, mom, weight32, lr, momentum, wd, rescale_grad,
            clip_gradient, kind):
    multi_sgd([weight], [grad], None if mom is None else [mom], [lr], [wd],
              momentum=momentum, kind=kind, rescale_grad=rescale_grad,
              clip_gradient=_clip_arg(clip_gradient),
              weights32=None if weight32 is None else [weight32])


@register("sgd_update", inplace=True)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    _sgd_op(weight, grad, None, None, lr, 0.0, wd, rescale_grad,
            clip_gradient, SGD_PLAIN)
    return weight


@register("sgd_mom_update", inplace=True)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    _sgd_op(weight, grad, mom, None, lr, momentum, wd, rescale_grad,
            clip_gradient, SGD_MOMENTUM)
    return weight, mom


@register("nag_mom_update", inplace=True)
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    _sgd_op(weight, grad, mom, None, lr, momentum, wd, rescale_grad,
            clip_gradient, SGD_NESTEROV)
    return weight, mom


@register("mp_sgd_update", inplace=True)
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    _sgd_op(weight, grad, None, weight32, lr, 0.0, wd, rescale_grad,
            clip_gradient, SGD_PLAIN)
    return weight, weight32


@register("mp_sgd_mom_update", inplace=True)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    _sgd_op(weight, grad, mom, weight32, lr, momentum, wd, rescale_grad,
            clip_gradient, SGD_MOMENTUM)
    return weight, mom, weight32


@register("mp_nag_mom_update", inplace=True)
def _mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    _sgd_op(weight, grad, mom, weight32, lr, momentum, wd, rescale_grad,
            clip_gradient, SGD_NESTEROV)
    return weight, mom, weight32


def _multi_sgd_op(arrays, stride, lrs, wds, momentum, rescale_grad,
                  clip_gradient, has_mom, has_mp, dev_lrs=None, dev_wds=None):
    n = len(arrays) // stride
    col = (lambda k: [arrays[i * stride + k] for i in range(n)])
    ws, gs = col(0), col(1)
    moms = col(2) if has_mom else None
    w32s = col(stride - 1) if has_mp else None
    multi_sgd(ws, gs, moms, None if dev_lrs is not None else list(lrs)[:n],
              None if dev_wds is not None else list(wds)[:n],
              dev_lrs=dev_lrs, dev_wds=dev_wds, momentum=momentum,
              kind=SGD_MOMENTUM if has_mom else SGD_PLAIN,
              rescale_grad=rescale_grad,
              clip_gradient=_clip_arg(clip_gradient), weights32=w32s)
    return tuple(ws) + tuple(moms or ()) + tuple(w32s or ())


@register("multi_sgd_update", inplace=True)
def _multi_sgd_update(*arrays, lrs=(), wds=(), rescale_grad=1.0,
                      clip_gradient=-1.0, num_weights=1):
    return _multi_sgd_op(arrays, 2, lrs, wds, 0.0, rescale_grad,
                         clip_gradient, False, False)


@register("multi_sgd_mom_update", inplace=True)
def _multi_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0,
                          num_weights=1):
    return _multi_sgd_op(arrays, 3, lrs, wds, momentum, rescale_grad,
                         clip_gradient, True, False)


@register("multi_mp_sgd_update", inplace=True)
def _multi_mp_sgd_update(*arrays, lrs=(), wds=(), rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=1):
    return _multi_sgd_op(arrays, 3, lrs, wds, 0.0, rescale_grad,
                         clip_gradient, False, True)


@register("multi_mp_sgd_mom_update", inplace=True)
def _multi_mp_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             num_weights=1):
    return _multi_sgd_op(arrays, 4, lrs, wds, momentum, rescale_grad,
                         clip_gradient, True, True)


def _preloaded(arrays, stride, momentum, rescale_grad, clip_gradient,
               has_mom, has_mp):
    lrs, wds = (a.reshape(-1).float().contiguous() for a in arrays[-2:])
    return _multi_sgd_op(arrays[:-2], stride, (), (), momentum, rescale_grad,
                         clip_gradient, has_mom, has_mp, dev_lrs=lrs,
                         dev_wds=wds)


@register("preloaded_multi_sgd_update", inplace=True)
def _preloaded_multi_sgd_update(*arrays, rescale_grad=1.0,
                                clip_gradient=-1.0, num_weights=1):
    return _preloaded(arrays, 2, 0.0, rescale_grad, clip_gradient, False,
                      False)


@register("preloaded_multi_sgd_mom_update", inplace=True)
def _preloaded_multi_sgd_mom_update(*arrays, momentum=0.0, rescale_grad=1.0,
                                    clip_gradient=-1.0, num_weights=1):
    return _preloaded(arrays, 3, momentum, rescale_grad, clip_gradient, True,
                      False)


@register("preloaded_multi_mp_sgd_update", inplace=True)
def _preloaded_multi_mp_sgd_update(*arrays, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=1):
    return _preloaded(arrays, 3, 0.0, rescale_grad, clip_gradient, False,
                      True)


@register("preloaded_multi_mp_sgd_mom_update", inplace=True)
def _preloaded_multi_mp_sgd_mom_update(*arrays, momentum=0.0,
                                       rescale_grad=1.0, clip_gradient=-1.0,
                                       num_weights=1):
    return _preloaded(arrays, 4, momentum, rescale_grad, clip_gradient, True,
                      True)


def _adam_op(ws, gs, ms, vs, lrs, wds, etas, beta1, beta2, epsilon,
             rescale_grad, clip_gradient, fold_wd, w32s=None):
    multi_adamw(ws, gs, ms, vs, lrs, wds, etas=etas, beta1=beta1,
                beta2=beta2, epsilon=epsilon, rescale_grad=rescale_grad,
                clip_gradient=_clip_arg(clip_gradient), fold_wd=fold_wd,
                weights32=w32s)


def _rescale_arg(r):
    return r.reshape(1).float() if isinstance(r, torch.Tensor) else r


@register("adam_update", inplace=True)
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    _adam_op([weight], [grad], [mean], [var], [lr], [wd], None, beta1, beta2,
             epsilon, rescale_grad, clip_gradient, True)
    return weight, mean, var


@register("adamw_update", inplace=True)
def _adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                  epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    _adam_op([weight], [grad], [mean], [var], [lr], [wd], [eta], beta1,
             beta2, epsilon, rescale_grad, clip_gradient, False)
    return weight, mean, var


@register("_adamw_update", inplace=True,
          inputs=("weight", "grad", "mean", "var", "rescale_grad"))
def _adamw_update_op(weight, grad, mean, var, rescale_grad, lr=0.001,
                     beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                     clip_gradient=-1.0):
    """AdamW with the gradient's rescale as a device scalar, read by O1 on
    the card (a dynamic loss scale needs no new launch parameters)."""
    _adam_op([weight], [grad], [mean], [var], [lr], [wd], [eta], beta1,
             beta2, epsilon, _rescale_arg(rescale_grad), clip_gradient,
             False)
    return weight, mean, var


@register("_mp_adamw_update", inplace=True,
          inputs=("weight", "grad", "mean", "var", "weight32",
                  "rescale_grad"))
def _mp_adamw_update_op(weight, grad, mean, var, weight32, rescale_grad,
                        lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                        wd=0.0, eta=1.0, clip_gradient=-1.0):
    _adam_op([weight], [grad], [mean], [var], [lr], [wd], [eta], beta1,
             beta2, epsilon, _rescale_arg(rescale_grad), clip_gradient,
             False, [weight32])
    return weight, mean, var, weight32


def _multi_adam_op(arrays, stride, lrs, wds, etas, beta1, beta2, epsilon,
                   clip_gradient, has_mp):
    scale, body = arrays[-1], arrays[:-1]
    n = len(body) // stride
    col = (lambda k: [body[i * stride + k] for i in range(n)])
    ws, gs, ms, vs = col(0), col(1), col(2), col(3)
    w32s = col(4) if has_mp else None
    _adam_op(ws, gs, ms, vs, list(lrs)[:n], list(wds)[:n], list(etas)[:n],
             beta1, beta2, epsilon, _rescale_arg(scale), clip_gradient,
             False, w32s)
    return tuple(ws) + tuple(ms) + tuple(vs) + tuple(w32s or ())


@register("_multi_adamw_update", inplace=True)
def _multi_adamw_update(*arrays, lrs=(), wds=(), etas=(), beta1=0.9,
                        beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                        num_weights=1):
    """Fused AdamW over a tensor list (O1 on the card); the last input is
    the device-scalar gradient rescale."""
    return _multi_adam_op(arrays, 4, lrs, wds, etas, beta1, beta2, epsilon,
                          clip_gradient, False)


@register("_multi_mp_adamw_update", inplace=True)
def _multi_mp_adamw_update(*arrays, lrs=(), wds=(), etas=(), beta1=0.9,
                           beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                           num_weights=1):
    return _multi_adam_op(arrays, 5, lrs, wds, etas, beta1, beta2, epsilon,
                          clip_gradient, True)


@register("multi_sum_sq")
def _multi_sum_sq(*arrays, num_arrays=1):
    """Each array's f32 sum of squares (O3 on the card)."""
    sums, _ = multi_sum_sq(arrays)
    return tuple(sums.unbind(0))


@register("all_finite")
def _all_finite(data, init_output=True):
    """1.0 iff every element is finite (O3's flag on the card)."""
    return multi_sum_sq([data])[1]


@register("multi_all_finite")
def _multi_all_finite(*arrays, num_arrays=1, init_output=True):
    return multi_sum_sq(arrays)[1]


@register("reset_arrays", inplace=True)
def _reset_arrays(*arrays, num_arrays=1):
    for a in arrays:
        a.zero_()
    return tuple(arrays)


# -- the ops the JAX package runs as plain elementwise code ------------------
# Plain torch, f32 intermediates, each stored value rounded once.

def _g32(grad, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    return g.clamp(-clip_gradient, clip_gradient) if clip_gradient >= 0 else g


@register("rmsprop_update", inplace=True)
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    w = weight.float()
    g = _g32(grad, rescale_grad, clip_gradient) + wd * w
    n.copy_(gamma1 * n.float() + (1 - gamma1) * g.square())
    w = w - lr * g / (n.float().sqrt() + epsilon)
    if clip_weights > 0:
        w = w.clamp(-clip_weights, clip_weights)
    weight.copy_(w)
    return weight, n


@register("rmspropalex_update", inplace=True)
def _rmspropalex_update(weight, grad, n, g_mean, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    w = weight.float()
    g = _g32(grad, rescale_grad, clip_gradient) + wd * w
    n.copy_(gamma1 * n.float() + (1 - gamma1) * g.square())
    g_mean.copy_(gamma1 * g_mean.float() + (1 - gamma1) * g)
    delta.copy_(gamma2 * delta.float() - lr * g / torch.sqrt(
        n.float() - g_mean.float().square() + epsilon))
    w = w + delta.float()
    if clip_weights > 0:
        w = w.clamp(-clip_weights, clip_weights)
    weight.copy_(w)
    return weight, n, g_mean, delta


@register("ftrl_update", inplace=True)
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    w = weight.float()
    g = _g32(grad, rescale_grad, clip_gradient)
    n_old = n.float()
    n_new = n_old + g.square()
    sigma = (n_new.sqrt() - n_old.sqrt()) / lr
    z_new = z.float() + g - sigma * w
    w = torch.where(z_new.abs() <= lamda1, torch.zeros_like(w),
                    -(z_new - z_new.sign() * lamda1)
                    / ((beta + n_new.sqrt()) / lr + wd))
    z.copy_(z_new)
    n.copy_(n_new)
    weight.copy_(w)
    return weight, z, n


@register("signsgd_update", inplace=True)
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    w = weight.float()
    g = _g32(grad, rescale_grad, clip_gradient)
    weight.copy_(w - lr * (g.sign() + wd * w))
    return weight


@register("signum_update", inplace=True)
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    w = weight.float()
    g = _g32(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom.float() - (1 - momentum) * (g + wd * w)
    mom.copy_(new_mom)
    weight.copy_((1 - lr * wd_lh) * w + lr * new_mom.sign())
    return weight, mom


def _lamb_phase1(w32, grad, mean, var, beta1, beta2, epsilon, t,
                 bias_correction, wd, rescale_grad, clip_gradient):
    g = _g32(grad, rescale_grad, clip_gradient)
    m = beta1 * mean.float() + (1 - beta1) * g
    v = beta2 * var.float() + (1 - beta2) * g.square()
    mean.copy_(m)
    var.copy_(v)
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    return m / (v.sqrt() + epsilon) + wd * w32


@register("lamb_update_phase1", inplace=True)
def _lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                        epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's update direction; mean and var are written in place (the
    reference's phase 1 does; the JAX package returns the direction only)."""
    return _lamb_phase1(weight.float(), grad, mean, var, beta1, beta2,
                        epsilon, t, bias_correction, wd, rescale_grad,
                        clip_gradient).to(weight.dtype)


@register("mp_lamb_update_phase1", inplace=True)
def _mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                           beta2=0.999, epsilon=1e-6, t=1,
                           bias_correction=True, wd=0.0, rescale_grad=1.0,
                           clip_gradient=-1.0):
    return _lamb_phase1(weight32, grad, mean, var, beta1, beta2, epsilon, t,
                        bias_correction, wd, rescale_grad, clip_gradient)


def _lamb_ratio(r1, r2, lower_bound, upper_bound):
    r1c = r1.float()
    if lower_bound >= 0:
        r1c = torch.clamp(r1c, min=lower_bound)
    if upper_bound >= 0:
        r1c = torch.clamp(r1c, max=upper_bound)
    r2 = r2.float()
    return torch.where((r1c > 0) & (r2 > 0), r1c / r2, torch.ones_like(r1c))


@register("lamb_update_phase2", inplace=True)
def _lamb_update_phase2(weight, g, r1, r2, lr=0.01, lower_bound=-1.0,
                        upper_bound=-1.0):
    ratio = _lamb_ratio(r1, r2, lower_bound, upper_bound)
    weight.copy_(weight.float() - lr * ratio * g.float())
    return weight


@register("mp_lamb_update_phase2", inplace=True)
def _mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr=0.01,
                           lower_bound=-1.0, upper_bound=-1.0):
    ratio = _lamb_ratio(r1, r2, lower_bound, upper_bound)
    weight32.copy_(weight32 - lr * ratio * g.float())
    weight.copy_(weight32)
    return weight, weight32


def _multi_lamb(ws, gs, ms, vs, w32s, learning_rates, wds, step_count, beta1,
                beta2, epsilon, rescale_grad, lower_bound, upper_bound,
                clip_gradient, bias_correction):
    """Every tensor's direction first, then one O3 read of the masters
    and the directions for both norms, then the steps."""
    masters = w32s if w32s is not None else [w.float() for w in ws]
    upds = []
    for i in range(len(ws)):
        upds.append(_lamb_phase1(masters[i], gs[i], ms[i], vs[i], beta1,
                                 beta2, epsilon, int(step_count[i]),
                                 bias_correction, float(wds[i]),
                                 rescale_grad, clip_gradient))
    sums, _ = multi_sum_sq(list(masters) + upds)
    norms = sums.sqrt()
    n = len(ws)
    for i in range(n):
        ratio = _lamb_ratio(norms[i], norms[n + i], lower_bound, upper_bound)
        new = masters[i] - float(learning_rates[i]) * ratio * upds[i]
        if w32s is not None:
            w32s[i].copy_(new)
        ws[i].copy_(new)


@register("_multi_lamb_update", inplace=True)
def _multi_lamb_update(*arrays, learning_rates=(), wds=(), step_count=(),
                       beta1=0.9, beta2=0.999, epsilon=1e-6,
                       rescale_grad=1.0, lower_bound=-1.0, upper_bound=-1.0,
                       clip_gradient=-1.0, bias_correction=True,
                       num_tensors=1):
    n = len(arrays) // 4
    col = (lambda k: [arrays[i * 4 + k] for i in range(n)])
    ws, gs, ms, vs = col(0), col(1), col(2), col(3)
    _multi_lamb(ws, gs, ms, vs, None, learning_rates, wds, step_count, beta1,
                beta2, epsilon, rescale_grad, lower_bound, upper_bound,
                clip_gradient, bias_correction)
    return tuple(ws) + tuple(ms) + tuple(vs)


@register("_multi_mp_lamb_update", inplace=True)
def _multi_mp_lamb_update(*arrays, learning_rates=(), wds=(), step_count=(),
                          beta1=0.9, beta2=0.999, epsilon=1e-6,
                          rescale_grad=1.0, lower_bound=-1.0,
                          upper_bound=-1.0, clip_gradient=-1.0,
                          bias_correction=True, num_tensors=1):
    n = len(arrays) // 5
    col = (lambda k: [arrays[i * 5 + k] for i in range(n)])
    ws, gs, ms, vs, w32s = col(0), col(1), col(2), col(3), col(4)
    _multi_lamb(ws, gs, ms, vs, w32s, learning_rates, wds, step_count, beta1,
                beta2, epsilon, rescale_grad, lower_bound, upper_bound,
                clip_gradient, bias_correction)
    return tuple(ws) + tuple(ms) + tuple(vs) + tuple(w32s)


@register("multi_lars")
def _multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
                rescale_grad=1.0):
    """LARS rates from per-tensor sums of squares."""
    w_norm = weights_sum_sq.float().sqrt()
    g2 = grads_sum_sq.float()
    lars = lrs * eta * w_norm / (g2.sqrt() * rescale_grad + wds * w_norm
                                 + eps)
    return torch.where((w_norm > 0) & (g2 > 0), lars, lrs)


@register("ftml_update", inplace=True)
def _ftml_update(weight, grad, d, v, z, lr=0.1, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    w = weight.float()
    g = rescale_grad * grad.float() + wd * w
    if clip_grad >= 0:
        g = g.clamp(-clip_grad, clip_grad)
    v_new = beta2 * v.float() + (1 - beta2) * g.square()
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(v_new / (1 - beta2 ** t))
                                   + epsilon)
    z_new = beta1 * z.float() + (1 - beta1) * g - (d_t - beta1 * d.float()) \
        * w
    d.copy_(d_t)
    v.copy_(v_new)
    z.copy_(z_new)
    weight.copy_(-z_new / d_t)
    return weight, d, v, z


@register("_sparse_adagrad_update", inplace=True)
def _sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                           wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Row-sparse AdaGrad: waits for the port's sparse arrays."""
    raise MXNetError("_sparse_adagrad_update takes row-sparse gradients; "
                     "ndarray/sparse.py is slice S7 of the port "
                     "(ROADMAP.md)")


@register("_contrib_group_adagrad_update", inplace=True)
def _group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                          clip_gradient=-1.0, epsilon=1e-5):
    """Per-row (group) AdaGrad: one accumulator per row."""
    g = _g32(grad, rescale_grad, clip_gradient)
    ssq = g.square().mean(dim=tuple(range(1, g.dim()))) if g.dim() > 1 \
        else g.square()
    hist = history.float() + ssq.reshape(history.shape)
    history.copy_(hist)
    denom = torch.sqrt(hist + epsilon).reshape((-1,) + (1,) * (g.dim() - 1))
    weight.copy_(weight.float() - lr * g / denom)
    return weight, history


