"""Neural-network operators: ``FullyConnected``, ``Convolution``,
``Deconvolution``, ``Pooling``, the norms, the activations and softmaxes,
``SoftmaxOutput``, ``Dropout``, ``Embedding``, the loss ops, the
``_contrib_*`` attention helpers, ``UpSampling``, ``BilinearSampler``
and ``RNN``: every op of the JAX package's ``ops/nn.py``.

The port's counterpart of the JAX package's ``ops/nn.py``, with the same
names, attrs and semantics; the Gluon layers call these functions, so
each op's rules live here once.  The JAX package runs these as plain
XLA (``lax.conv_general_dilated``, ``lax.reduce_window``, ``jnp``,
``lax.scan``): no Pallas kernel lies on this path, and the port's
convolutions, transposed ones included, and its recurrences run through
cuDNN (``torch.nn.functional.conv*d`` and ``conv_transpose*d``; torch's
fused ``_VF.lstm``/``gru``/``rnn_tanh``/``rnn_relu``).

Layout: every spatial op takes ``layout``.  A channel-first layout
(``NCW``/``NCHW``/``NCDHW``) takes OIHW-style weights; a channels-last
one (``NWC``/``NHWC``/``NDHWC``) takes channels-last data and HWIO-style
weights, as the JAX package's dimension numbers say.  A channels-last
operand is permuted to its channel-first view (no copy: contiguous NHWC
memory is ``torch.channels_last``), computed there and permuted back.
``Deconvolution`` takes the channel-first layouts only and raises
``ValueError`` on the others, as the JAX package does.

AMP: every op on one of AMP's lists passes its inputs through
``amp.transform_inputs``, as the JAX package's dispatcher does for every
op.  ``Convolution``, ``Deconvolution`` and ``FullyConnected`` are on the
target-dtype list; off AMP a convolution runs in its weight's dtype, as
``nn.Dense`` does.  ``BatchNorm`` runs in its input's dtype.  The other
norms, the softmaxes and the loss ops are on AMP's f32 list: under AMP
their inputs are cast to f32, so they return f32; off AMP the norms take
their statistics and affine in f32 and return the input's dtype (the JAX
package's rule).

``BatchNorm`` is the JAX package's formula, not ``F.batch_norm``'s: in
train mode the statistics are taken in one pass in f32, shifted by the
running mean ``c`` (``var = E[(x-c)^2] - (E[x]-c)^2``, floored at
``E[(x-c)^2] * 2^-20``); the running variance is updated with that
biased batch variance as ``old * momentum + new * (1 - momentum)``;
``scale`` and ``shift`` are formed per channel in f32 and rounded to the
input's dtype, and the normalisation runs in that dtype.  Its train-mode
backward is a ``torch.autograd.Function`` that keeps the input in its
own dtype and per-channel f32 statistics, never an f32 copy of the
activation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp as _amp
from .registry import register, register_invoke_override

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _as_tuple(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


def channel_last(layout):
    """Whether ``layout`` keeps its channels last (``NWC``, ``NHWC``,
    ``NDHWC``)."""
    return not layout.startswith("NC")


def to_channel_first(x):
    """The channel-first view of a channels-last tensor."""
    return x.movedim(-1, 1)


def to_channel_last(x):
    """The channels-last view of a channel-first tensor."""
    return x.movedim(1, -1)


# ----------------------------------------------------------------------------
# FullyConnected
# ----------------------------------------------------------------------------


@register("FullyConnected", aliases=("fully_connected",),
          inputs=("data", "weight", "bias"))
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True):
    """Parity: src/operator/nn/fully_connected.cc: ``y = x W^T + b`` with
    W (num_hidden, in_units), ``flatten`` folding every axis after the
    first.  The product is taken in the promoted dtype (a bf16 product
    accumulates in f32) and returned in the data's, as the JAX
    package's ``preferred_element_type=f32`` then ``astype`` does; a
    bias of the same dtype is added in the product's epilogue."""
    data, weight, bias = _amp.transform_inputs("FullyConnected",
                                               (data, weight, bias))
    x = data.reshape(data.shape[0], -1) if flatten else data
    dt = torch.promote_types(x.dtype, weight.dtype)
    if no_bias:
        bias = None
    if bias is not None and bias.dtype == x.dtype == weight.dtype:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dt), weight.to(dt)).to(x.dtype)
    return y if bias is None else y + bias


# ----------------------------------------------------------------------------
# Convolution
# ----------------------------------------------------------------------------


@register("Convolution", aliases=("convolution",),
          inputs=("data", "weight", "bias"))
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False,
                 layout="NCHW", cudnn_tune=None, cudnn_off=False,
                 workspace=1024):
    """Parity: src/operator/nn/convolution.cc.  ``weight`` is OIHW for a
    channel-first ``layout`` and HWIO for a channels-last one."""
    data, weight, bias = _amp.transform_inputs("Convolution",
                                               (data, weight, bias))
    data = data.to(weight.dtype)
    nd = len(kernel) if kernel else weight.dim() - 2
    stride = _as_tuple(stride, nd) if stride else (1,) * nd
    dilate = _as_tuple(dilate, nd) if dilate else (1,) * nd
    pad = _as_tuple(pad, nd) if pad else (0,) * nd
    last = channel_last(layout)
    if last:
        data = to_channel_first(data)
        weight = weight.permute(nd + 1, nd, *range(nd))
    if no_bias or bias is None:
        bias = None
    else:
        bias = bias.to(weight.dtype)
    out = _CONV[nd](data, weight, bias, stride, pad, dilate, num_group)
    return to_channel_last(out) if last else out


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def deconv_geometry(in_shape, kernel, stride, dilate, pad, adj,
                    target_shape):
    """``(pad, adj)`` of a transposed convolution, solved from
    ``target_shape`` where it is given (deconvolution-inl.h InferPad:
    ``pad = (total + 1) // 2``, ``adj = total % 2``, as the JAX package
    does; a target larger than the full output gives a negative pad)."""
    if not target_shape:
        return pad, adj
    nd = len(kernel)
    target = _as_tuple(target_shape, nd)
    total = [dilate[i] * (kernel[i] - 1) + stride[i] * (in_shape[i] - 1)
             + 1 - target[i] for i in range(nd)]
    return tuple((t + 1) // 2 for t in total), tuple(t % 2 for t in total)


@register("Deconvolution", aliases=("deconvolution",),
          inputs=("data", "weight", "bias"))
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), target_shape=(), num_filter=0,
                   num_group=1, no_bias=True, layout="NCHW", cudnn_tune=None,
                   cudnn_off=False, workspace=1024):
    """Transposed convolution (parity: src/operator/nn/deconvolution.cc):
    ``weight`` is (C_in, C_out / num_group, *kernel); each spatial size
    is ``(in - 1) * stride - 2 * pad + dilate * (kernel - 1) + 1 + adj``.

    The JAX package's result is the full transposed output (pad 0) cut
    from ``pad`` on, with zeros where the cut runs past it.  Where torch
    takes the geometry (``pad >= 0`` and ``adj < max(stride, dilate)``)
    that is ``F.conv_transpose*d`` with ``output_padding=adj``; elsewhere
    (a larger ``adj``, or the negative ``pad`` of a large
    ``target_shape``) it is the full output cut and padded with zeros."""
    if layout not in ("NCHW", "NCW", "NCDHW"):
        raise ValueError("Deconvolution: channel-first layouts only")
    data, weight, bias = _amp.transform_inputs("Deconvolution",
                                               (data, weight, bias))
    in_dtype = data.dtype
    data = data.to(weight.dtype)
    nd = weight.dim() - 2
    kernel = tuple(kernel) if kernel else tuple(weight.shape[2:])
    stride = _as_tuple(stride, nd) if stride else (1,) * nd
    dilate = _as_tuple(dilate, nd) if dilate else (1,) * nd
    pad = _as_tuple(pad, nd) if pad else (0,) * nd
    adj = _as_tuple(adj, nd) if adj else (0,) * nd
    pad, adj = deconv_geometry(data.shape[2:], kernel, stride, dilate, pad,
                               adj, target_shape)
    if no_bias or bias is None:
        bias = None
    else:
        bias = bias.to(weight.dtype)
    conv = _CONV_T[nd]
    if all(p >= 0 and 0 <= a < max(s, d)
           for p, a, s, d in zip(pad, adj, stride, dilate)):
        out = conv(data, weight, bias, stride, pad, adj, num_group, dilate)
        return out.to(in_dtype)
    full = conv(data, weight, None, stride, 0, 0, num_group, dilate)
    flat = []
    for i in reversed(range(nd)):
        size = (data.shape[2 + i] - 1) * stride[i] - 2 * pad[i] \
            + dilate[i] * (kernel[i] - 1) + 1 + adj[i]
        flat += [-pad[i], size - (full.shape[2 + i] - pad[i])]
    out = F.pad(full, flat)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out.to(in_dtype)


# ----------------------------------------------------------------------------
# Pooling
# ----------------------------------------------------------------------------


def _window_pads(shape, kernel, stride, pad, full):
    """The JAX package's (lo, hi) padding per spatial dim: ``full``
    (ceil mode) pads the high side until the last window fits."""
    pads = []
    for size, k, s, p in zip(shape, kernel, stride, pad):
        hi = p
        if full:
            rem = (size + 2 * p - k) % s
            if rem:
                hi += s - rem
        pads.append((p, hi))
    return pads


def _torch_pool_fits(shape, kernel, stride, pad, pads, full):
    """Whether torch's own padded (and ceil-mode) max pooling gives the
    JAX package's windows: padding at most half a window, and the same
    number of windows per dim (in ceil mode torch drops a last window
    that starts in the padding, the JAX package keeps it)."""
    for size, k, s, p, (lo, hi) in zip(shape, kernel, stride, pad, pads):
        if p > k // 2:
            return False
        span = size + 2 * p - k
        got = (-(-span // s) if full else span // s) + 1
        if full and (got - 1) * s >= size + p:
            got -= 1
        if got != (size + lo + hi - k) // s + 1:
            return False
    return True


def _pad_spatial(x, pads, value):
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _window_sum(x, kernel, stride):
    """Sum over each window of a padded channel-first ``x``."""
    nd = len(kernel)
    if nd == 1:
        out = F.avg_pool2d(x.unsqueeze(-2), (1,) + tuple(kernel),
                           (1,) + tuple(stride), divisor_override=1)
        return out.squeeze(-2)
    pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return pool(x, tuple(kernel), tuple(stride), divisor_override=1)


@register("Pooling", aliases=("pooling",))
def _pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
             global_pool=False, pooling_convention="valid", layout="NCHW",
             count_include_pad=True, cudnn_off=False):
    """Parity: src/operator/nn/pooling.cc (the JAX package's
    ``reduce_window`` windows: explicit padding, ``full`` as ceil mode,
    ``avg`` over the whole window with ``count_include_pad`` else over
    its unpadded part, ``lp`` as the 2-norm)."""
    last = channel_last(layout)
    if global_pool:
        spatial = tuple(range(1, data.dim() - 1)) if last \
            else tuple(range(2, data.dim()))
        if pool_type == "max":
            return torch.amax(data, dim=spatial, keepdim=True)
        return torch.mean(data, dim=spatial, keepdim=True)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError("unknown pool_type %r" % pool_type)
    x = to_channel_first(data) if last else data
    nd = len(kernel)
    stride = _as_tuple(stride, nd) if stride else (1,) * nd
    pad = _as_tuple(pad, nd) if pad else (0,) * nd
    kernel = tuple(kernel)
    shape = x.shape[2:]
    full = pooling_convention == "full"
    pads = _window_pads(shape, kernel, stride, pad, full)
    if pool_type == "max":
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
        if _torch_pool_fits(shape, kernel, stride, pad, pads, full):
            out = pool(x, kernel, stride, pad, ceil_mode=full)
        else:
            out = pool(_pad_spatial(x, pads, -math.inf), kernel, stride)
    else:
        src = x.abs() ** 2 if pool_type == "lp" else x
        summed = _window_sum(_pad_spatial(src, pads, 0.0), kernel, stride)
        if pool_type == "sum":
            out = summed
        elif pool_type == "lp":
            out = torch.sqrt(summed)
        elif count_include_pad:
            out = summed / torch.tensor(float(math.prod(kernel)),
                                        dtype=x.dtype)
        else:
            ones = torch.ones((1, 1) + tuple(shape), dtype=x.dtype,
                              device=x.device)
            out = summed / _window_sum(_pad_spatial(ones, pads, 0.0),
                                       kernel, stride)
    return to_channel_last(out) if last else out


# ----------------------------------------------------------------------------
# BatchNorm
# ----------------------------------------------------------------------------

_VAR_FLOOR = 2.0 ** -20


def _bn_geometry(data, axis):
    ax = axis % data.dim()
    reduce = tuple(i for i in range(data.dim()) if i != ax)
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    return reduce, bshape, data.numel() // max(data.shape[ax], 1)


def _scale_shift(g, beta, mean, inv, dtype):
    """Per-channel ``scale = g * inv`` and ``shift = beta - mean * g *
    inv``, formed in f32 and rounded to ``dtype``."""
    return (g * inv).to(dtype), (beta - mean * g * inv).to(dtype)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm with the JAX package's shifted one-pass
    statistics; the backward is the gradient of that formula (what the
    JAX package's autodiff takes), from the input in its own dtype and
    per-channel f32 tensors.  Returns ``(out, mean, var)``; ``mean`` and
    ``var`` (f32, per channel) carry no gradient."""

    @staticmethod
    def forward(ctx, data, gamma, beta, c, eps, axis, fix_gamma):
        reduce, bshape, _ = _bn_geometry(data, axis)
        xc = torch.sub(data, c.view(bshape))       # f32
        d1 = xc.mean(reduce)
        d2 = xc.square().mean(reduce)
        del xc
        mean = c + d1
        var = torch.maximum(d2 - d1 * d1, d2 * _VAR_FLOOR)
        inv = torch.rsqrt(var + eps)
        g = torch.ones_like(c) if fix_gamma else gamma.float()
        scale, shift = _scale_shift(g, beta.float(), mean, inv, data.dtype)
        out = torch.addcmul(shift.view(bshape), data, scale.view(bshape))
        ctx.save_for_backward(data, c, d1, d2, g, mean, var, inv, scale)
        ctx.eps, ctx.axis, ctx.fix_gamma = eps, axis, fix_gamma
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        data, c, d1, d2, g, mean, var, inv, scale = ctx.saved_tensors
        reduce, bshape, m = _bn_geometry(data, ctx.axis)
        dy = dy.to(data.dtype)
        # out = data * scale + shift, scale and shift per channel
        d_shift = dy.sum(reduce, dtype=torch.float32)
        d_scale = (dy * data).sum(reduce, dtype=torch.float32)
        # scale = g * inv; shift = beta - (mean * g) * inv
        d_mg = -d_shift * inv
        d_inv = d_scale * g - d_shift * (mean * g)
        d_gamma = d_scale * inv + d_mg * mean
        d_mean = d_mg * g
        # inv = rsqrt(var + eps)
        d_var = d_inv * -0.5 * inv / (var + ctx.eps)
        # var = max(d2 - d1^2, d2 * 2^-20), ties split as jnp.maximum does
        a = d2 - d1 * d1
        b = d2 * _VAR_FLOOR
        w_a = (a > b).float() + 0.5 * (a == b).float()
        d_a = d_var * w_a
        d_d2 = d_a + d_var * (1.0 - w_a) * _VAR_FLOOR
        # mean = c + d1, d1 = E[x - c], d2 = E[(x - c)^2]
        d_d1 = d_mean - 2.0 * d1 * d_a
        d_xc = torch.addcmul((d_d1 / m).view(bshape),
                             torch.sub(data, c.view(bshape)),
                             (2.0 * d_d2 / m).view(bshape))
        dx = torch.addcmul(d_xc.to(data.dtype), dy, scale.view(bshape))
        d_g = None
        if ctx.needs_input_grad[1]:
            d_g = torch.zeros_like(d_gamma) if ctx.fix_gamma else d_gamma
        return dx, d_g, d_shift, None, None, None, None


@register("BatchNorm", aliases=("batch_norm",), needs_mode=True)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                _mode="predict"):
    """Parity: src/operator/nn/batch_norm.cc.  Returns ``(out,
    new_moving_mean, new_moving_var)``; the caller writes the new
    statistics back (``nn.BatchNorm`` does, in place), as in the JAX
    package."""
    reduce, bshape, _ = _bn_geometry(data, axis)
    if _mode == "train" and not use_global_stats:
        # the shift: the running mean as it is now, never a view of it
        c = moving_mean.detach().to(torch.float32, copy=True)
        out, mean, var = _BatchNormTrain.apply(data, gamma, beta, c,
                                               float(eps), axis,
                                               bool(fix_gamma))
        with torch.no_grad():
            new_mm = moving_mean * momentum \
                + mean.to(moving_mean.dtype) * (1 - momentum)
            new_mv = moving_var * momentum \
                + var.to(moving_var.dtype) * (1 - momentum)
        return out, new_mm, new_mv
    mean = moving_mean.float()
    inv = torch.rsqrt(moving_var.float() + eps)
    g = torch.ones_like(mean) if fix_gamma else gamma.float()
    scale, shift = _scale_shift(g, beta.float(), mean, inv, data.dtype)
    out = torch.addcmul(shift.view(bshape), data, scale.view(bshape))
    return out, moving_mean, moving_var


# ----------------------------------------------------------------------------
# LayerNorm, InstanceNorm, GroupNorm
# ----------------------------------------------------------------------------


@register("LayerNorm", aliases=("layer_norm",))
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Parity: src/operator/nn/layer_norm.cc: over ``axis``, in f32 (the
    biased variance, ``(x - mean) * rsqrt(var + eps)``, then the f32
    affine), returned in the data's dtype.  ``output_mean_var`` is
    accepted and ignored, as in the JAX package."""
    del output_mean_var
    data, gamma, beta = _amp.transform_inputs("LayerNorm",
                                              (data, gamma, beta))
    x = data.float().movedim(axis, -1)
    out = F.layer_norm(x, x.shape[-1:], gamma.float(), beta.float(), eps)
    return out.movedim(-1, axis).to(data.dtype)


@register("InstanceNorm", aliases=("instance_norm",))
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Parity: src/operator/instance_norm.cc: each (sample, channel) over
    the axes after the channel (axis 1), in f32, returned in the data's
    dtype."""
    data, gamma, beta = _amp.transform_inputs("InstanceNorm",
                                              (data, gamma, beta))
    out = F.group_norm(data.float(), data.shape[1], gamma.float(),
                       beta.float(), eps)
    return out.to(data.dtype)


@register("GroupNorm", aliases=("group_norm",))
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Parity: src/operator/nn/group_norm.cc: each sample's channels
    (axis 1) in ``num_groups`` groups, each group with the axes after
    the channel, in f32, returned in the data's dtype."""
    data, gamma, beta = _amp.transform_inputs("GroupNorm",
                                              (data, gamma, beta))
    out = F.group_norm(data.float(), int(num_groups), gamma.float(),
                       beta.float(), eps)
    return out.to(data.dtype)


@register("L2Normalization", aliases=("l2_normalization",))
def _l2_normalization(data, eps=1e-10, mode="instance"):
    """Parity: src/operator/l2_normalization.cc: ``data`` over the
    square root of its sum of squares (plus ``eps``) over every axis
    after the first (``instance``), the channel axis (``channel``) or
    the axes after it (``spatial``), in the data's dtype."""
    (data,) = _amp.transform_inputs("L2Normalization", (data,))
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, data.dim()))
    norm = torch.sqrt(torch.sum(torch.square(data), axes, keepdim=True)
                      + eps)
    return data / norm


@register("RMSNorm", aliases=("rms_norm",))
def _rms_norm(data, gamma, axis=-1, eps=1e-6):
    """The JAX package's RMSNorm (no reference counterpart): ``x *
    rsqrt(mean(x^2) + eps) * gamma`` over ``axis`` in f32, returned in
    the data's dtype."""
    data, gamma = _amp.transform_inputs("RMSNorm", (data, gamma))
    x = data.float()
    ms = torch.mean(torch.square(x), axis, keepdim=True)
    return (x * torch.rsqrt(ms + eps) * gamma.float()).to(data.dtype)


# ----------------------------------------------------------------------------
# Activations
# ----------------------------------------------------------------------------

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's
    "silu": F.silu,
    "erf": torch.erf,
}


@register("softmax", inputs=("data", "length"))
def _softmax(data, axis=-1, temperature=None, length=None, use_length=False,
             dtype=None):
    """Parity: ops/nn.py softmax (``temperature``, ``use_length`` with a
    per-sample ``length`` along ``axis``, ``dtype``).  Under AMP it
    computes in f32 (it is on AMP's f32 list)."""
    (data,) = _amp.transform_inputs("softmax", (data,))
    x = data if temperature in (None, 1.0) else data / temperature
    if use_length and length is not None:
        steps = torch.arange(x.shape[axis], device=x.device)
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        mask = steps.reshape(shape) < length.reshape(
            [x.shape[0]] + [1] * (x.dim() - 1))
        x = torch.where(mask, x, float("-inf"))
    out = torch.softmax(x, dim=axis)
    return out if dtype is None else out.to(_tdtype(dtype))


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None, dtype=None):
    """Parity: ops/nn.py log_softmax."""
    (data,) = _amp.transform_inputs("log_softmax", (data,))
    x = data if temperature in (None, 1.0) else data / temperature
    out = torch.log_softmax(x, dim=axis)
    return out if dtype is None else out.to(_tdtype(dtype))


def _tdtype(dtype):
    from .tensor import to_torch_dtype

    return to_torch_dtype(dtype)


@register("softmin")
def _softmin(data, axis=-1):
    """Parity: softmin: the softmax of ``-data`` along ``axis``."""
    (data,) = _amp.transform_inputs("softmin", (data,))
    return torch.softmax(-data, dim=axis)


@register("SoftmaxActivation")
def _softmax_activation(data, mode="instance"):
    """Parity: SoftmaxActivation: over axis 1 (``channel``) or over every
    axis after the first (``instance``)."""
    (data,) = _amp.transform_inputs("SoftmaxActivation", (data,))
    if mode == "channel":
        return torch.softmax(data, dim=1)
    flat = data.reshape(data.shape[0], -1)
    return torch.softmax(flat, dim=-1).reshape(data.shape)


def _hot(label, k, dtype):
    """One-hot rows of ``label`` (truncated to integers) over ``k``
    classes, a row of zeros for a label outside ``[0, k)``, as
    ``jax.nn.one_hot`` gives."""
    idx = label.to(torch.int32).unsqueeze(-1)
    return (idx == torch.arange(k, device=label.device)).to(dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """The legacy fused softmax and cross-entropy head: the forward is
    the softmax over the last axis; the backward ignores the incoming
    gradient and gives ``(p - onehot(label)) * scale`` (parity:
    src/operator/softmax_output-inl.h), with ``scale`` the JAX
    package's: ``grad_scale``, over the batch under ``normalization=
    "batch"``, over the labels other than ``ignore_label`` under
    ``"valid"`` with ``use_ignore``; with ``use_ignore`` the ignored
    rows get no gradient.  The label gets none."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization):
        prob = torch.softmax(data, dim=-1)
        ctx.save_for_backward(prob, label)
        ctx.args = (grad_scale, ignore_label, use_ignore, normalization)
        return prob

    @staticmethod
    def backward(ctx, _grad):
        prob, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization = ctx.args
        scale = grad_scale
        if normalization == "batch":
            scale = scale / prob.shape[0]
        keep = (label != ignore_label).to(prob.dtype)
        if normalization == "valid" and use_ignore:
            scale = scale / torch.clamp(keep.sum(), min=1.0)
        grad = (prob - _hot(label, prob.shape[-1], prob.dtype)) * scale
        if use_ignore:
            grad = grad * keep.unsqueeze(-1)
        return grad.to(prob.dtype), None, None, None, None, None


@register("SoftmaxOutput", aliases=("softmax_output",))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """Parity: src/operator/softmax_output.cc, as the JAX package keeps
    it: ``multi_output``, ``preserve_shape``, ``out_grad`` and
    ``smooth_alpha`` are accepted and ignored."""
    data, label = _amp.transform_inputs("SoftmaxOutput", (data, label))
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(use_ignore),
                                normalization)


@register("Activation", aliases=("activation",))
def _activation(data, act_type="relu"):
    """Parity: src/operator/nn/activation.cc (``gelu`` is the tanh
    approximation, as ``jax.nn.gelu``'s default)."""
    return _ACTIVATIONS[act_type](data)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU", aliases=("leaky_relu",), inputs=("data", "gamma"),
          needs_rng=True, needs_mode=True)
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, _mode="predict"):
    """Parity: src/operator/leaky_relu.cc.  ``rrelu`` in train mode
    draws its slopes from torch's default generator on the data's device
    (the JAX package's from its key: compared by moments only)."""
    pos = data > 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if data.dim() > 2 else gamma
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * (torch.exp(data) - 1.0))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            pos, data, _SELU_ALPHA * (torch.exp(data) - 1.0))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        if _mode == "train":
            s = torch.empty(data.shape, dtype=torch.float32,
                            device=data.device).uniform_(lower_bound,
                                                         upper_bound)
            return torch.where(pos, data, s.to(data.dtype) * data)
        return torch.where(pos, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise ValueError("unknown act_type %r" % act_type)


# ----------------------------------------------------------------------------
# Dropout
# ----------------------------------------------------------------------------


@register("Dropout", aliases=("dropout",), needs_rng=True, needs_mode=True)
def _dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
             _mode="predict", generator=None):
    """Parity: src/operator/nn/dropout.cc: in train mode (or
    ``mode="always"``) each element, or each slice along ``axes``, is
    kept with probability ``1 - p`` and scaled by ``1 / (1 - p)``.  The
    mask comes from ``generator`` (default: torch's on the data's
    device), so it is compared with the JAX package's by moments."""
    if (_mode != "train" and mode != "always") or p <= 0.0:
        return data
    shape = list(data.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = torch.empty(shape, dtype=torch.float32, device=data.device) \
        .uniform_(generator=generator) < 1.0 - p
    return torch.where(keep, data / (1.0 - p), torch.zeros((), dtype=data.dtype,
                                                          device=data.device))


# ----------------------------------------------------------------------------
# Embedding
# ----------------------------------------------------------------------------


def _fill_value(dtype):
    """What ``jnp.take`` gives for an index out of range: NaN for a
    floating table, the lowest value for a signed one, the highest for
    an unsigned one."""
    if dtype.is_floating_point or dtype.is_complex:
        return math.nan
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _truthy(flag):
    return flag in (True, 1, "1", "true", "True")


def sparse_grad_active(sparse_grad, in_graph):
    """Whether an ``Embedding`` call takes the row-sparse gradient
    (:func:`embedding_rows`): with ``sparse_grad`` while
    ``autograd.record()`` records and the weight takes a gradient
    (``in_graph``), as in the JAX package; elsewhere the dense op runs.
    The op and its invoke override both ask this."""
    from .. import autograd

    return _truthy(sparse_grad) and autograd.is_recording() \
        and torch.is_grad_enabled() and bool(in_graph)


def embedding_rows(data, weight):
    """``Embedding`` with a row-sparse gradient (parity: indexing_op.cc's
    kRowSparseStorage backward): float ids are truncated and every id is
    clipped into ``[0, n)`` (``jnp.take(mode="clip")``, as the JAX
    package's sparse forward reads), and the weight's gradient holds the
    rows the forward read, duplicate ids summed: torch's sparse COO
    gradient of ``F.embedding(sparse=True)``, which the NDArray and Gluon
    gradient rules keep row-sparse.  The JAX package lists the raw ids
    instead, so an id out of range moves another row, or none
    (ROADMAP.md R15); here it moves the row it read.  A weight that is
    not a leaf gets a dense gradient, as the JAX package densifies a
    row-sparse cotangent into an interior node."""
    n = weight.shape[0]
    ids = data.to(torch.int32).long() if data.is_floating_point() \
        else data.long()
    return F.embedding(ids.clamp(0, max(n - 1, 0)), weight,
                       sparse=weight.grad_fn is None)


@register("Embedding", aliases=("embedding",))
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    """Parity: src/operator/tensor/indexing_op.cc Embedding, as the JAX
    package computes it (``jnp.take(weight, ids, axis=0)``): float ids
    are truncated to integers, an id in ``[-n, 0)`` counts from the end
    of the ``n``-row table, and any other id outside ``[0, n)`` gives a
    row of the fill value (NaN for a float table).  The ids are clamped
    and the rows masked on the device, so no id reaches the gather out
    of range and nothing waits on the host; the gradient reaches the
    rows of ids in range only.  With ``sparse_grad`` under ``record()``
    the call is :func:`embedding_rows` (``sparse_grad_active``)."""
    if sparse_grad_active(sparse_grad, weight.requires_grad):
        return embedding_rows(data, weight)
    n = weight.shape[0]
    ids = data.to(torch.int32).long() if data.is_floating_point() \
        else data.long()
    valid = (ids >= -n) & (ids < n)
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, max(n - 1, 0))
    if weight.dim() == 2:
        rows = F.embedding(ids, weight)
    else:
        rows = torch.index_select(weight, 0, ids.reshape(-1)).reshape(
            ids.shape + weight.shape[1:])
    mask = valid.reshape(valid.shape + (1,) * (weight.dim() - 1))
    return torch.where(mask, rows,
                       rows.new_full((), _fill_value(weight.dtype)))


def _embedding_sparse_invoke(inputs, attrs, out):
    """``nd.Embedding(sparse_grad=True)`` while recording, with the weight
    in the graph: one eager call outside any bulk segment (the gradient's
    row count depends on the ids), as the JAX package's override runs
    it; every other call goes to the dispatcher."""
    from .registry import invoke_fn

    if out is not None or len(inputs) < 2 or not sparse_grad_active(
            attrs.get("sparse_grad"), inputs[1]._in_graph):
        return NotImplemented
    return invoke_fn(lambda d, w: (embedding_rows(d, w),), inputs[:2],
                     op_name="Embedding")[0]


register_invoke_override("Embedding", _embedding_sparse_invoke)


# ----------------------------------------------------------------------------
# Loss ops
# ----------------------------------------------------------------------------


@register("smooth_l1")
def _smooth_l1(data, scalar=1.0):
    """Parity: smooth_l1: ``0.5 * s^2 * x^2`` where ``|x| < 1 / s^2``,
    ``|x| - 0.5 / s^2`` elsewhere (``s`` is ``scalar``)."""
    (data,) = _amp.transform_inputs("smooth_l1", (data,))
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """Parity: softmax_cross_entropy: the sum over the batch of each
    row's cross-entropy against its (truncated) label."""
    data, label = _amp.transform_inputs("softmax_cross_entropy",
                                        (data, label))
    logp = torch.log_softmax(data, dim=-1)
    return torch.sum(-_hot(label, data.shape[-1], logp.dtype) * logp)


@register("CTCLoss", aliases=("ctc_loss",),
          inputs=("data", "label", "data_lengths", "label_lengths"))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """Parity: CTCLoss (src/operator/nn/ctc_loss.cc): ``data`` (T, B, C)
    logits, ``label`` (B, L) class indices; the blank is class 0
    (``"first"``) or C-1 (``"last"``).  Without ``label_lengths`` a
    sequence's length is its count of labels other than the padding,
    0 with the blank first and -1 with it last; without
    ``data_lengths`` every sequence has T frames.  Returns the negative
    log-likelihood of each sequence, in ``data``'s dtype, and zeros of
    ``data``'s shape (the JAX package's second output).  The sum over
    paths is ``F.ctc_loss`` on the f32 log-softmax (the JAX package runs
    its own scan; no Pallas kernel stands behind it).  A sequence no
    path can emit gives inf, where the JAX package's -1e30 floor gives
    a large finite value."""
    t, b, c = data.shape
    logp = F.log_softmax(data.float(), dim=-1)
    blank = 0 if blank_label == "first" else c - 1
    labels = label.long()
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.long()
    else:
        lab_len = (labels != (0 if blank_label == "first" else -1)).sum(1)
    if use_data_lengths and data_lengths is not None:
        dat_len = data_lengths.long()
    else:
        dat_len = torch.full((b,), t, dtype=torch.long, device=data.device)
    # torch reads only each row's first lab_len labels: the padding is
    # made a valid index, never used
    loss = F.ctc_loss(logp, labels.clamp(0, c - 1), dat_len, lab_len,
                      blank=blank, reduction="none")
    return loss.to(data.dtype), torch.zeros_like(data)


# ----------------------------------------------------------------------------
# RNN (vanilla/LSTM/GRU) — parity: src/operator/rnn.cc:299
# ----------------------------------------------------------------------------


def _gates(mode):
    return {"rnn_tanh": 1, "rnn_relu": 1, "lstm": 4, "gru": 3}[mode]


def _unpack_rnn_params(params, mode, num_layers, input_size, state_size,
                       bidirectional):
    """Views into the reference's packed parameter vector (rnn-inl.h
    layout): for each layer and direction ``W_x`` (G*H, in) then ``W_h``
    (G*H, H); then, in the same order, every ``b_x`` and ``b_h``.  Returns
    ``[(wx, wh, bx, bh), ...]`` a layer and direction, the forward
    direction first."""
    G = _gates(mode)
    dirs = 2 if bidirectional else 1
    offset = 0

    def take(n, shape):
        nonlocal offset
        out = params[offset:offset + n].view(shape)
        offset += n
        return out

    weights = []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        for _ in range(dirs):
            weights.append((take(G * state_size * in_size,
                                 (G * state_size, in_size)),
                            take(G * state_size * state_size,
                                 (G * state_size, state_size))))
    biases = [(take(G * state_size, (G * state_size,)),
               take(G * state_size, (G * state_size,)))
              for _ in range(num_layers * dirs)]
    return [w + b for w, b in zip(weights, biases)]


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False):
    """Length of the packed parameter vector (parity: rnn-inl.h)."""
    G = _gates(mode)
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        total += dirs * G * state_size * (in_size + state_size + 2)
    return total


_FUSED = {"rnn_tanh": torch._VF.rnn_tanh, "rnn_relu": torch._VF.rnn_relu,
          "lstm": torch._VF.lstm, "gru": torch._VF.gru}


def _fused_stack(mode, x, layers, h0, c0, bidirectional, train):
    """One call of torch's fused recurrence over ``layers`` (each
    ``(wx, wh, bx, bh)``, directions innermost): cuDNN's RNN on the
    card, ATen's loop on the host.  Its own dropout is never used (it
    ignores the port's generators and is a hazard under capture)."""
    flat = [t for layer in layers for t in layer]
    dirs = 2 if bidirectional else 1
    n = len(layers) // dirs
    if mode == "lstm":
        out, h, c = _FUSED[mode](x, (h0, c0), flat, True, n, 0.0, train,
                                 bidirectional, False)
        return out, h, c
    out, h = _FUSED[mode](x, h0, flat, True, n, 0.0, train, bidirectional,
                          False)
    return out, h, c0


def rnn_fused(data, layers, state, state_cell=None, num_layers=1,
              mode="lstm", bidirectional=False, p=0.0, training=False,
              generator=None):
    """The recurrence of the ``RNN`` op on a list of per-layer weights
    (``[(wx, wh, bx, bh), ...]``, a layer and direction each, as
    :func:`_unpack_rnn_params` gives them): the Gluon layers hand their
    parameters here as they are.  ``data`` (T, B, I), ``state`` (and for
    the LSTM ``state_cell``) (L*dirs, B, H).  Returns ``(out (T, B,
    H*dirs), h_n, c_n)``; ``c_n`` of a mode other than the LSTM is
    ``state_cell``, zeros where none was given, as in the JAX package.

    With ``p > 0`` in train mode the output of every layer but the last
    goes through the port's ``Dropout`` (``generator``), so the fused
    function runs once a layer; otherwise once for the stack.  The gate
    orders are torch's and the JAX package's alike (i, f, g, o; r, z, n
    with the reset gate on ``W_h h + b_h``)."""
    c0 = state_cell if state_cell is not None else torch.zeros_like(state)
    dirs = 2 if bidirectional else 1
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in [data, state, c0]
        + [w for layer in layers for w in layer])
    if not (p > 0.0 and training) or num_layers == 1:
        return _fused_stack(mode, data, layers, state, c0, bidirectional,
                            train)
    x, hs, cs = data, [], []
    for layer in range(num_layers):
        sl = slice(layer * dirs, (layer + 1) * dirs)
        x, h, c = _fused_stack(mode, x, layers[sl], state[sl], c0[sl],
                               bidirectional, train)
        hs.append(h)
        cs.append(c)
        if layer < num_layers - 1:
            x = _dropout(x, p=p, _mode="train", generator=generator)
    return x, torch.cat(hs), torch.cat(cs)


def _rnn_cell_step(mode, x, h, c, wx, wh, bx, bh):
    if mode == "rnn_tanh":
        return torch.tanh(x @ wx.T + bx + h @ wh.T + bh), c
    if mode == "rnn_relu":
        return torch.relu(x @ wx.T + bx + h @ wh.T + bh), c
    if mode == "lstm":
        gates = x @ wx.T + bx + h @ wh.T + bh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c2), c2
    if mode == "gru":
        rx, zx, nx = torch.chunk(x @ wx.T + bx, 3, dim=-1)
        rh, zh, nh = torch.chunk(h @ wh.T + bh, 3, dim=-1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        n = torch.tanh(nx + r * nh)
        return (1 - z) * n + z * h, c
    raise ValueError(mode)


def _rnn_plain(data, layers, state, state_cell=None, num_layers=1,
               mode="lstm", bidirectional=False, p=0.0, training=False,
               generator=None):
    """:func:`rnn_fused`'s plain version: the JAX package's
    ``_rnn_cell_step`` loop over time, a layer and direction at a time.
    The tests and ``chip_smoke.py`` hold the fused route to it; nothing
    on the main path calls it."""
    c0 = state_cell if state_cell is not None else torch.zeros_like(state)
    dirs = 2 if bidirectional else 1
    x, h_out, c_out = data, [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            wx, wh, bx, bh = layers[layer * dirs + d]
            h, c = state[layer * dirs + d], c0[layer * dirs + d]
            seq = x if d == 0 else torch.flip(x, (0,))
            ys = []
            for xt in seq:
                h, c = _rnn_cell_step(mode, xt, h, c, wx, wh, bx, bh)
                ys.append(h)
            ys = torch.stack(ys)
            outs.append(ys if d == 0 else torch.flip(ys, (0,)))
            h_out.append(h)
            c_out.append(c)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and training and layer < num_layers - 1:
            x = _dropout(x, p=p, _mode="train", generator=generator)
    return x, torch.stack(h_out), torch.stack(c_out)


@register("RNN", aliases=("rnn",), needs_rng=True, needs_mode=True,
          inputs=("data", "parameters", "state", "state_cell"))
def _rnn(data, parameters, state, state_cell=None, state_size=0,
         num_layers=1, mode="lstm", bidirectional=False, p=0.0,
         state_outputs=True, projection_size=None, use_sequence_length=False,
         _mode="predict", generator=None):
    """Parity: src/operator/rnn.cc:299, as the JAX package registers it:
    ``data`` (T, B, I), the packed ``parameters`` (:func:`rnn_param_size`
    long), ``state`` and, for the LSTM, ``state_cell`` (L*dirs, B, H).
    Returns ``(out (T, B, H*dirs), h_n, c_n)`` whatever
    ``state_outputs`` says.  ``projection_size`` and
    ``use_sequence_length`` are accepted and ignored, as the JAX op
    ignores them.  Dropout ``p`` between layers applies in train mode
    only.  The recurrence is :func:`rnn_fused` (cuDNN on the card) on
    views into ``parameters``; under AMP it runs in the target dtype."""
    data, parameters, state, state_cell = _amp.transform_inputs(
        "RNN", (data, parameters, state, state_cell))
    layers = _unpack_rnn_params(parameters, mode, num_layers, data.shape[2],
                                state_size, bidirectional)
    return rnn_fused(data, layers, state, state_cell, num_layers=num_layers,
                     mode=mode, bidirectional=bidirectional, p=p,
                     training=_mode == "train", generator=generator)


# ----------------------------------------------------------------------------
# Attention helpers (reference: src/operator/contrib/transformer.cc)
# ----------------------------------------------------------------------------


def _heads(qkv, heads, which):
    """Part ``which`` (0 q, 1 k, 2 v) of an interleaved (T, B, 3*H*D)
    projection as (B*H, T, D)."""
    t, b, _ = qkv.shape
    x = qkv.reshape(t, b, heads, 3, -1)[:, :, :, which, :]
    return x.permute(1, 2, 0, 3).reshape(b * heads, t, x.shape[-1])


@register("_contrib_interleaved_matmul_selfatt_qk")
def _interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """(T, B, 3*H*D) interleaved q, k, v → the scaled ``q k^T`` (B*H, T,
    T); the scale ``1 / sqrt(D)`` is formed in f32 and rounded to the
    data's dtype, as the JAX package does."""
    (qkv,) = _amp.transform_inputs(
        "_contrib_interleaved_matmul_selfatt_qk", (queries_keys_values,))
    q, k = _heads(qkv, heads, 0), _heads(qkv, heads, 1)
    inv = 1.0 / torch.tensor(float(q.shape[-1])).sqrt()       # f32
    scale = inv.to(q.dtype).item()
    return torch.matmul(q * scale, k.transpose(-1, -2))


@register("_contrib_interleaved_matmul_selfatt_valatt")
def _interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                       heads=1):
    """The attention (B*H, T, T) applied to the interleaved v → (T, B,
    H*D)."""
    qkv, attention = _amp.transform_inputs(
        "_contrib_interleaved_matmul_selfatt_valatt",
        (queries_keys_values, attention))
    t, b, _ = qkv.shape
    v = _heads(qkv, heads, 2)
    d = v.shape[-1]
    out = torch.matmul(attention, v).reshape(b, heads, t, d)
    return out.permute(2, 0, 1, 3).reshape(t, b, heads * d)


@register("_contrib_arange_like")
def _arange_like(data, start=0.0, step=1.0, axis=None):
    """``start + step * i`` in the data's dtype over every element of
    ``data`` (in its shape), or along ``axis``."""
    n = data.numel() if axis is None else data.shape[axis]
    out = (start + step * torch.arange(n, dtype=torch.float64,
                                       device=data.device)).to(data.dtype)
    return out.reshape(data.shape) if axis is None else out


@register("_contrib_div_sqrt_dim")
def _div_sqrt_dim(data):
    """``data`` over the square root of its last axis's size, formed in
    the data's dtype."""
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype)).item()


# ----------------------------------------------------------------------------
# UpSampling, BilinearSampler
# ----------------------------------------------------------------------------


@register("UpSampling", aliases=("upsampling",))
def _upsampling(*data, scale=2, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    """Parity: src/operator/nn/upsampling.cc, nearest only, as the JAX
    package computes it: the first input's rows and columns each
    repeated ``scale`` times; ``sample_type`` and the other inputs are
    ignored."""
    x = data[0]
    return torch.repeat_interleave(
        torch.repeat_interleave(x, scale, dim=2), scale, dim=3)


@register("BilinearSampler", aliases=("bilinear_sampler",))
def _bilinear_sampler(data, grid, cudnn_off=False):
    """Parity: src/operator/bilinear_sampler.cc: ``data`` (N, C, H, W)
    sampled at ``grid`` (N, 2, Ho, Wo) of x, y in [-1, 1]; the four
    neighbours' indices are clamped to the map, their weights are not
    (the JAX package's formula)."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0).unsqueeze(-1)
    wy = (gy - y0).unsqueeze(-1)
    b = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def gather(yy, xx):
        yy = yy.to(torch.int32).long().clamp(0, h - 1)
        xx = xx.to(torch.int32).long().clamp(0, w - 1)
        return data[b, :, yy, xx]                   # (n, ho, wo, c)

    out = (gather(y0, x0) * (1 - wx) * (1 - wy)
           + gather(y0, x0 + 1) * wx * (1 - wy)
           + gather(y0 + 1, x0) * (1 - wx) * wy
           + gather(y0 + 1, x0 + 1) * wx * wy)
    return out.permute(0, 3, 1, 2)
