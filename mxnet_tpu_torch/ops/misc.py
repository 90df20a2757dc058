"""Misc and legacy operators: the loss layers, im2col/col2im, LRN, the
histogram, the image ops, the spatial transformer family, adaptive
pooling, correlation, the scatter and slice-assign ops, and the legacy
aliases.

The port's counterpart of the JAX package's ``ops/misc.py``, op for op,
with its names, aliases, attributes, defaults and formulas.  The loss
layers whose reference backward ignores the incoming gradient
(``*RegressionOutput``, ``SVMOutput``, ``MakeLoss``) and the
straight-through ops are ``torch.autograd.Function``s, where the JAX
package has ``jax.custom_vjp``.  ``cast_storage`` and ``_sparse_retain``
keep the JAX package's dense meaning (every storage type is a dense
buffer here); ``_sharding_constraint`` returns its input on one device
and raises ``MXNetError`` when given a sharding (slice S8).  The
``_v1`` ops, ``CuDNNBatchNorm``, ``_CrossDeviceCopy``, ``_split_v2``
and ``MakeLoss_grad_stop`` are aliases of the modern ops, as in the JAX
package.
"""
from __future__ import annotations

import builtins
import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .contrib import _scatter_rows
from .registry import alias, register

# ----------------------------------------------------------------------------
# simple elementwise and reduction ops
# ----------------------------------------------------------------------------


@register("add_n", aliases=("ElementWiseSum", "_sum"))
def _add_n(*arrays, num_args=1):
    """The sum of the inputs, added left to right."""
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


@register("hard_sigmoid")
def _hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


def _axes(axes, ndim):
    return tuple(range(ndim)) if axes is None else (
        tuple(axes) if isinstance(axes, (tuple, list)) else (axes,))


@register("moments")
def _moments(data, axes=None, keepdims=False):
    """``(mean, variance)`` over ``axes`` (all when None)."""
    ax = _axes(axes, data.dim())
    mean = torch.mean(data, dim=ax, keepdim=keepdims)
    dev = data - torch.mean(data, dim=ax, keepdim=True)
    return mean, torch.mean(dev * dev, dim=ax, keepdim=keepdims)


@register("_square_sum")
def _square_sum(data, axis=None, keepdims=False):
    return torch.sum(data * data, dim=_axes(axis, data.dim()),
                     keepdim=keepdims)


@register("_grad_add")
def _grad_add(lhs, rhs):
    return lhs + rhs


@register("_hypot_scalar")
def _hypot_scalar(data, scalar=0.0):
    return torch.hypot(data, torch.full_like(data, scalar))


@register("_zeros_without_dtype")
def _zeros_without_dtype(shape=(), ctx=None, device=None):
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("_rnn_param_concat")
def _rnn_param_concat(*arrays, dim=0, num_args=1):
    """Concatenate along ``dim``; at dim 0 with inputs of mixed ranks,
    the inputs of rank above 1 are flattened first."""
    if dim == 0 and any(a.dim() != arrays[0].dim() for a in arrays):
        return torch.cat([a.reshape(-1) if a.dim() != 1 else a
                          for a in arrays], dim=0)
    return torch.cat(arrays, dim=dim)


@register("batch_take")
def _batch_take(a, indices):
    """Row i's element ``indices[i]`` of ``a`` flattened to (N, -1)."""
    flat = a.reshape(a.shape[0], -1)
    idx = indices.reshape(-1, 1).to(torch.int64)
    idx = torch.where(idx < 0, idx + flat.shape[1], idx)
    return torch.gather(flat, 1, idx).reshape(indices.shape)


@register("_unravel_index")
def _unravel_index(data, shape=()):
    """Flat indices to coordinates: (len(shape), *data.shape), int32."""
    idx = data.to(torch.int64).reshape(-1)
    coords = []
    for d in reversed(tuple(shape)):
        coords.append(torch.remainder(idx, d))
        idx = torch.div(idx, d, rounding_mode="floor")
    out = torch.stack(coords[::-1], dim=0).to(torch.int32)
    return out.reshape((len(shape),) + tuple(data.shape))


@register("_ravel_multi_index")
def _ravel_multi_index(data, shape=()):
    """Coordinates (each clipped into its axis) to flat indices, in the
    data's dtype."""
    out = torch.zeros(data.shape[1:], dtype=torch.int64, device=data.device)
    for i, d in enumerate(shape):
        c = data[i].to(torch.int32).to(torch.int64).clamp(0, d - 1)
        out = out * d + c
    return out.to(data.dtype)


def _linspace(start, stop, num, device):
    """``jnp.linspace`` in f32: ``start*(1 - s) + stop*s`` with ``s = i /
    (num - 1)``, the last point ``stop`` itself."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=device)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


@register("_histogram")
def _histogram(data, bins=None, bin_cnt=None, range=None):
    """``(counts (f32), edges)`` of the flattened data, as
    ``jnp.histogram`` counts them: bins closed on the left, the last one
    on both sides, values outside dropped.  ``bins`` may be the edges."""
    x = data.reshape(-1)
    x = x if x.is_floating_point() else x.to(torch.float32)
    if bins is not None and getattr(bins, "ndim", 0) > 0:
        edges = torch.as_tensor(np.asarray(bins) if not isinstance(
            bins, torch.Tensor) else bins, device=x.device).to(x.dtype)
    else:
        lo, hi = range if range is not None else (0.0, 1.0)
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = _linspace(lo, hi, int(bin_cnt or 10) + 1, x.device) \
            .to(x.dtype)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], edges.shape[0] - 1, idx)
    counts = torch.zeros(edges.shape[0] + 1, dtype=x.dtype, device=x.device)
    counts = counts.index_add(0, idx, torch.ones_like(x))
    return counts[1:edges.shape[0]], edges


@register("_sparse_retain")
def _sparse_retain(data, indices):
    """Keep only the listed rows (others zeroed): the dense rendering of
    the row-sparse retain (reference: tensor/sparse_retain.cc)."""
    ones = torch.ones(indices.numel(), dtype=data.dtype, device=data.device)
    mask = _scatter_rows(data.new_zeros(data.shape[0]), indices, ones)
    return data * mask.reshape((-1,) + (1,) * (data.dim() - 1))


@register("cast_storage")
def _cast_storage(data, stype="default"):
    """The identity: the registered op is the dense rendering, as in the
    JAX package's; ``nd.cast_storage`` gives sparse arrays of eager
    arrays (``ndarray/__init__.py``)."""
    return data


def _as_dtype_scalar(x, dtype):
    """``x`` cast into ``dtype`` (a 0-d host tensor, read as a scalar by
    ops on any device), as ``jnp.asarray(x, dtype)``."""
    return torch.tensor(x).to(dtype)


@register("_scatter_plus_scalar")
def _scatter_plus_scalar(data, scalar=0.0):
    return data + _as_dtype_scalar(scalar, data.dtype)


@register("_scatter_minus_scalar")
def _scatter_minus_scalar(data, scalar=0.0):
    return data - _as_dtype_scalar(scalar, data.dtype)


@register("_scatter_elemwise_div")
def _scatter_elemwise_div(lhs, rhs):
    return lhs / rhs


def _slice_index(shape, begin, end, step, device):
    """Open-mesh index tensors of the MXNet slice (any step sign) over the
    leading ``len(begin)`` axes."""
    steps = step if step else (None,) * len(begin)
    idx = []
    for axis, (b, e, s) in enumerate(zip(begin, end, steps)):
        r = builtins.range(shape[axis])[slice(
            b, e, s if s not in (None, 0) else None)]
        t = torch.arange(r.start, r.stop, r.step, device=device)
        view = [1] * len(begin)
        view[axis] = -1
        idx.append(t.reshape(view))
    return tuple(idx)


@register("_slice_assign")
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """``lhs`` with the slice ``[begin:end:step]`` set to ``rhs``."""
    out = lhs.clone()
    out[_slice_index(lhs.shape, begin, end, step, lhs.device)] = \
        rhs.to(lhs.dtype)
    return out


@register("_slice_assign_scalar")
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    out = data.clone()
    out[_slice_index(data.shape, begin, end, step, data.device)] = \
        _as_dtype_scalar(scalar, data.dtype).to(data.device)
    return out


alias("_split_v2", "split_v2")
alias("MakeLoss_grad_stop", "stop_gradient")

# ----------------------------------------------------------------------------
# loss-layer ops: the reference's backward ignores the incoming gradient
# ----------------------------------------------------------------------------


class _LossLayer(torch.autograd.Function):
    """Forward ``fwd(data)``; the data's gradient is ``grad(out, label) *
    grad_scale / num_output``, whatever comes in."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, fwd, grad):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad_scale, ctx.grad = grad_scale, grad
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        num_output = label.numel() // label.shape[0] if label.dim() > 0 \
            else 1
        lab = label.reshape(out.shape) if label.numel() == out.numel() \
            else label
        scale = float(np.float32(ctx.grad_scale) / np.float32(num_output))
        return ctx.grad(out, lab) * scale, None, None, None, None


def _loss_layer(name, fwd, grad):
    def op(data, label, grad_scale=1.0):
        return _LossLayer.apply(data, label, grad_scale, fwd, grad)

    op.__doc__ = ("Parity: regression_output.cc %s; the data's gradient "
                  "ignores the incoming one." % name)
    register(name, aliases=(name.lower().replace("output", "_output"),))(op)
    return op


_loss_layer("LinearRegressionOutput", lambda d: d, lambda o, l: o - l)
_loss_layer("MAERegressionOutput", lambda d: d,
            lambda o, l: torch.sign(o - l))
_loss_layer("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l)


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, coef, linear):
        ctx.save_for_backward(data, label)
        ctx.margin, ctx.coef, ctx.linear = margin, coef, linear
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        d, lab = ctx.saved_tensors
        margin = ctx.margin
        x = d.reshape(d.shape[0], -1)
        k = F.one_hot(lab.reshape(-1).to(torch.int64), x.shape[1]) > 0
        if ctx.linear:      # L1-SVM
            at_k = -(margin > x).to(x.dtype)
            off_k = (margin > -x).to(x.dtype)
        else:               # L2-SVM
            zero = torch.zeros_like(x)
            at_k = torch.where(margin > x, -2.0 * (margin - x), zero)
            off_k = torch.where(margin > -x, 2.0 * (margin + x), zero)
        grad = torch.where(k, at_k, off_k) * ctx.coef
        return grad.reshape(d.shape), None, None, None, None


@register("SVMOutput", aliases=("svm_output",))
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    """Forward identity; backward the L1 or L2 SVM margin gradient
    (parity: svm_output.cc)."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        ctx.save_for_backward(data)
        ctx.args = grad_scale, valid_thresh, normalization
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        grad_scale, valid_thresh, normalization = ctx.args
        if normalization == "valid":
            n_valid = (d > valid_thresh).sum().clamp_min(1)
            return (torch.full_like(d, grad_scale) / n_valid, None, None,
                    None)
        scale = grad_scale / d.shape[0] if normalization == "batch" \
            else grad_scale
        return torch.full_like(d, scale), None, None, None


@register("MakeLoss")
def _make_loss_op(data, grad_scale=1.0, valid_thresh=0.0,
                  normalization="null"):
    """Terminal loss marker: forward identity, backward a constant
    ``grad_scale`` field (reference: make_loss.cc ignores the head
    gradient)."""
    return _MakeLoss.apply(data, float(grad_scale), float(valid_thresh),
                           normalization)


class _KLSparseReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, target, penalty):
        ctx.save_for_backward(data)
        ctx.args = target, penalty
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        target, penalty = ctx.args
        rho = torch.clamp(torch.mean(d, dim=0, keepdim=True), 1e-6,
                          1 - 1e-6)
        kl = penalty * (-target / rho + (1 - target) / (1 - rho))
        return g + kl, None, None


@register("IdentityAttachKLSparseReg")
def _identity_kl_sparse(data, sparseness_target=0.1, penalty=0.001,
                        momentum=0.9):
    """The identity whose backward adds the KL-sparseness penalty's
    gradient, from the batch's mean activation (reference:
    identity_attach_KL_sparse_reg-inl.h; the moving average collapses
    into the batch estimate, as in the JAX package)."""
    return _KLSparseReg.apply(data, float(sparseness_target),
                              float(penalty))


# ----------------------------------------------------------------------------
# straight-through estimators, quadratic, allclose (contrib)
# ----------------------------------------------------------------------------


@register("_contrib_round_ste")
def _round_ste(data):
    return data + (torch.round(data) - data).detach()


@register("_contrib_sign_ste")
def _sign_ste(data):
    return data + (torch.sign(data) - data).detach()


@register("_contrib_quadratic", aliases=("_contrib_backward_quadratic",))
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    return a * (data * data) + b * data + c


@register("_contrib_allclose")
def _allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """1.0 if every element is close, else 0.0 (f32, shape (1,)), on the
    device."""
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan) \
        .all().to(torch.float32).reshape(1)


# ----------------------------------------------------------------------------
# im2col / col2im (reference: src/operator/nn/im2col.h)
# ----------------------------------------------------------------------------


def _conv_tuple(v, n):
    if v is None:
        return (1,) * n
    t = tuple(int(x) for x in (v if isinstance(v, (tuple, list)) else (v,)))
    return t * n if len(t) == 1 and n > 1 else t


def _geometry(kernel, stride, dilate, pad):
    nd = len(kernel)
    return (_conv_tuple(kernel, nd), _conv_tuple(stride or (1,) * nd, nd),
            _conv_tuple(dilate or (1,) * nd, nd),
            _conv_tuple(pad or (0,) * nd, nd))


@register("im2col")
def _im2col(data, kernel=(), stride=(), dilate=(), pad=()):
    """(N, C, *spatial) -> (N, C*prod(kernel), L): each window's values,
    channel-major then kernel taps, as ``conv_general_dilated_patches``
    lays them out (1, 2 or 3 spatial axes)."""
    k, s, d, p = _geometry(kernel, stride, dilate, pad)
    nd = len(k)
    x = F.pad(data, [q for pi in reversed(p) for q in (pi, pi)])
    sp = x.shape[2:]
    o = tuple((sp[i] - d[i] * (k[i] - 1) - 1) // s[i] + 1
              for i in range(nd))
    taps = []
    for tap in itertools.product(*(range(ki) for ki in k)):
        sl = (slice(None), slice(None)) + tuple(
            slice(tap[i] * d[i], tap[i] * d[i] + (o[i] - 1) * s[i] + 1, s[i])
            for i in range(nd))
        taps.append(x[sl])
    out = torch.stack(taps, dim=2)              # (N, C, taps, *o)
    return out.reshape(out.shape[0], -1, math.prod(o))


@register("col2im")
def _col2im(data, output_size=(), kernel=(), stride=(), dilate=(), pad=()):
    """N-D col2im (1D/2D/3D, as the reference's im2col_nd_core,
    src/operator/nn/im2col.h:150): each kernel tap's column added back
    onto its strided output window, taps in order."""
    k, s, d, p = _geometry(kernel, stride, dilate, pad)
    ndim = len(k)
    out_sp = tuple(int(x) for x in output_size)
    n = data.shape[0]
    c = data.shape[1] // math.prod(k)
    o = tuple((out_sp[i] + 2 * p[i] - d[i] * (k[i] - 1) - 1) // s[i] + 1
              for i in range(ndim))
    cols = data.reshape((n, c) + tuple(k) + o)
    out = data.new_zeros((n, c) + tuple(out_sp[i] + 2 * p[i]
                                        for i in range(ndim)))
    for taps in itertools.product(*(range(ki) for ki in k)):
        dst = (slice(None), slice(None)) + tuple(
            slice(taps[i] * d[i], taps[i] * d[i] + o[i] * s[i], s[i])
            for i in range(ndim))
        out[dst] = out[dst] + cols[(slice(None), slice(None)) + taps]
    unpad = (slice(None), slice(None)) + tuple(
        slice(p[i], p[i] + out_sp[i]) for i in range(ndim))
    return out[unpad]


# ----------------------------------------------------------------------------
# LRN (reference: src/operator/nn/lrn.cc: two outputs, out and tmp_norm)
# ----------------------------------------------------------------------------


@register("LRN", aliases=("lrn",))
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    half = int(nsize) // 2
    sq = data * data
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    c = data.shape[1]
    window = padded[:, 0:c]
    for i in range(1, int(nsize)):
        window = window + padded[:, i:i + c]
    tmp_norm = knorm + (alpha / nsize) * window
    return data * torch.pow(tmp_norm, -beta), tmp_norm


@register("Crop", aliases=("crop_legacy",))
def _crop_op(*arrays, num_args=1, offset=(0, 0), h_w=(0, 0),
             center_crop=False):
    """Legacy Crop (reference: src/operator/crop.cc): input 0 cut
    spatially to ``h_w``, or to the size of a second input."""
    data = arrays[0]
    if len(arrays) > 1:
        th, tw = arrays[1].shape[2], arrays[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if center_crop:
        oy = (data.shape[2] - th) // 2
        ox = (data.shape[3] - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


# ----------------------------------------------------------------------------
# image ops (reference: src/operator/image/*.cc; HWC in, CHW out for
# to_tensor)
# ----------------------------------------------------------------------------


@register("_image_to_tensor")
def _image_to_tensor(data):
    x = data.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if data.dim() == 3 else x.permute(0, 3, 1, 2)


@register("_image_normalize")
def _image_normalize(data, mean=(0.0,), std=(1.0,)):
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    m = torch.tensor(mean, dtype=torch.float32, device=data.device)
    s = torch.tensor(std, dtype=torch.float32, device=data.device)
    return (data - m.reshape(shape)) / s.reshape(shape)


@register("_image_crop")
def _image_crop(data, x=0, y=0, width=1, height=1):
    if data.dim() == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


# AlexNet's PCA lighting table, eigval * eigvec (image_random-inl.h)
_EIG = np.asarray(
    [[55.46 * -0.5675, 4.794 * 0.7192, 1.148 * 0.4009],
     [55.46 * -0.5808, 4.794 * -0.0045, 1.148 * -0.8140],
     [55.46 * -0.5836, 4.794 * -0.6948, 1.148 * 0.4203]], np.float32)


def _lighting(data, pca):
    out = data.to(torch.float32) + pca
    if not data.dtype.is_floating_point:
        info = torch.iinfo(data.dtype)
        out = out.clamp(info.min, info.max)
    return out.to(data.dtype)


@register("_image_adjust_lighting")
def _image_adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """PCA lighting jitter (parity: image_random-inl.h AdjustLightingImpl,
    the same table); HWC or NHWC.  An integer image saturates."""
    if data.shape[-1] == 1:
        return data
    a = np.asarray(alpha, np.float32)
    pca = [float((_EIG[i, 0] * a[0] + _EIG[i, 1] * a[1]) + _EIG[i, 2] * a[2])
           for i in range(3)]
    return _lighting(data, torch.tensor(pca, dtype=torch.float32,
                                        device=data.device))


@register("_image_random_lighting", needs_rng=True)
def _image_random_lighting(data, alpha_std=0.05):
    """Lighting with alpha ~ N(0, alpha_std) a channel, drawn from
    torch's default generator of the data's device."""
    if data.shape[-1] == 1:
        return data
    a = torch.randn(3, device=data.device) * alpha_std
    eig = torch.tensor(_EIG, device=data.device)
    return _lighting(data, eig @ a)


@register("_image_resize")
def _image_resize(data, size=(), keep_ratio=False, interp=1):
    """Resize an HWC (or NHWC) image to ``size`` (w, h) in f32: linear
    with half-pixel centres (antialiased when shrinking, as
    ``jax.image.resize``), or nearest for ``interp=0``."""
    if isinstance(size, int):
        size = (size, size)
    w, h = int(size[0]), int(size[1]) if len(size) > 1 else int(size[0])
    x = data.to(torch.float32)
    x4 = (x[None] if data.dim() == 3 else x).permute(0, 3, 1, 2)
    if interp == 0:
        y = F.interpolate(x4, size=(h, w), mode="nearest-exact")
    else:
        y = F.interpolate(x4, size=(h, w), mode="bilinear",
                          align_corners=False,
                          antialias=h < x4.shape[2] or w < x4.shape[3])
    y = y.permute(0, 2, 3, 1)
    return y[0] if data.dim() == 3 else y


# ----------------------------------------------------------------------------
# spatial transformer family (reference: grid_generator.cc,
# spatial_transformer.cc, contrib/bilinear_resize.cc,
# contrib/adaptive_avg_pooling.cc)
# ----------------------------------------------------------------------------


def _affine_grid(theta, h, w):
    """theta (N, 6) -> the normalized sampling grid (N, 2, H, W), xy."""
    n = theta.shape[0]
    dev = theta.device
    gy, gx = torch.meshgrid(_linspace(-1.0, 1.0, h, dev),
                            _linspace(-1.0, 1.0, w, dev), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=0).reshape(3, -1)
    grid = torch.einsum("nij,jk->nik", theta.reshape(n, 2, 3),
                        base.to(theta.dtype))
    return grid.reshape(n, 2, h, w)


@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    h, w = int(target_shape[0]), int(target_shape[1])
    if transform_type == "affine":
        return _affine_grid(data, h, w)
    # warp: a (N, 2, H, W) flow in pixels added to the base grid, then
    # normalized to [-1, 1]
    n, _, fh, fw = data.shape
    gy, gx = torch.meshgrid(
        torch.arange(fh, dtype=data.dtype, device=data.device),
        torch.arange(fw, dtype=data.dtype, device=data.device),
        indexing="ij")
    x = (gx[None] + data[:, 0]) * 2.0 / max(fw - 1, 1) - 1.0
    y = (gy[None] + data[:, 1]) * 2.0 / max(fh - 1, 1) - 1.0
    return torch.stack([x, y], dim=1)


def _bilinear_sample(data, grid):
    """Sample NCHW ``data`` at the normalized xy ``grid`` (N, 2, H', W');
    a corner outside the map contributes 0."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    flat = data.reshape(n, c, h * w)

    def gather(yi, xi):
        yc = yi.clamp(0, h - 1).to(torch.int64)
        xc = xi.clamp(0, w - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
        return torch.gather(flat, 2, idx).reshape((n, c) + tuple(gx.shape[1:]))

    def inside(yi, xi):
        ok = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        return ok.to(data.dtype)[:, None]

    return (gather(y0, x0) * inside(y0, x0) * ((1 - wx) * (1 - wy))[:, None]
            + gather(y0, x0 + 1) * inside(y0, x0 + 1)
            * (wx * (1 - wy))[:, None]
            + gather(y0 + 1, x0) * inside(y0 + 1, x0)
            * ((1 - wx) * wy)[:, None]
            + gather(y0 + 1, x0 + 1) * inside(y0 + 1, x0 + 1)
            * (wx * wy)[:, None])


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    h, w = int(target_shape[0]), int(target_shape[1])
    return _bilinear_sample(data, _affine_grid(loc, h, w))


@register("_contrib_BilinearResize2D")
def _bilinear_resize2d(data, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size"):
    """Align-corners bilinear resize of NCHW data (the reference
    kernel's)."""
    n, c, h, w = data.shape
    oh = int(round(h * scale_height)) if scale_height else int(height)
    ow = int(round(w * scale_width)) if scale_width else int(width)
    dev = data.device
    ys = _linspace(0.0, h - 1, oh, dev)
    xs = _linspace(0.0, w - 1, ow, dev)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    gx = grid_x * 2.0 / max(w - 1, 1) - 1.0
    gy = grid_y * 2.0 / max(h - 1, 1) - 1.0
    grid = torch.stack([gx, gy])[None].expand(n, 2, oh, ow)
    return _bilinear_sample(data, grid.to(data.dtype))


def _adaptive_weights(in_len, out_len):
    """The (out, in) averaging matrix over the adaptive windows
    [floor(i*in/out), ceil((i+1)*in/out))."""
    a = np.zeros((out_len, in_len), np.float32)
    for i in builtins.range(out_len):
        lo = (i * in_len) // out_len
        hi = -(-((i + 1) * in_len) // out_len)
        a[i, lo:hi] = 1.0 / (hi - lo)
    return a


@register("_contrib_AdaptiveAvgPooling2D")
def _adaptive_avg_pool2d(data, output_size=(1, 1)):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh = int(output_size[0])
    ow = int(output_size[1]) if len(output_size) > 1 else oh
    n, c, h, w = data.shape
    ah = torch.from_numpy(_adaptive_weights(h, oh)).to(data.device,
                                                       data.dtype)
    aw = torch.from_numpy(_adaptive_weights(w, ow)).to(data.device,
                                                       data.dtype)
    return torch.einsum("oh,nchw,pw->ncop", ah, data, aw)


# ----------------------------------------------------------------------------
# Correlation (reference: src/operator/correlation.cc, FlowNet's cost
# volume): two outputs, the volume and zeros
# ----------------------------------------------------------------------------


def _window(x, y0, x0, hh, ww, s):
    """``lax.dynamic_slice`` of (hh, ww) at (y0, x0) (its start clamped
    so the window fits), then every ``s``-th row and column."""
    y0 = min(max(y0, 0), x.shape[2] - hh)
    x0 = min(max(x0, 0), x.shape[3] - ww)
    return x[:, :, y0:y0 + hh:s, x0:x0 + ww:s]


@register("Correlation")
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    n, c, h, w = data1.shape
    pad = int(pad_size)
    k = int(kernel_size)
    bor = k // 2
    d = int(max_displacement) // int(stride2)
    s1, s2 = int(stride1), int(stride2)
    # extra bottom/right padding so the strided windows never overrun
    p1 = F.pad(data1, (pad, pad + s1, pad, pad + s1))
    p2 = F.pad(data2, (pad, pad + s1, pad, pad + s1))
    ph, pw = h + 2 * pad, w + 2 * pad
    oh = -(-(ph - 2 * bor - 2 * d * s2) // s1)
    ow = -(-(pw - 2 * bor - 2 * d * s2) // s1)
    base = d * s2 + bor
    sumelems = k * k * c
    a = _window(p1, base, base, oh * s1, ow * s1, s1)
    outs = []
    for dy in builtins.range(-d, d + 1):
        for dx in builtins.range(-d, d + 1):
            b = _window(p2, base + dy * s2, base + dx * s2, oh * s1,
                        ow * s1, s1)
            prod = a * b if is_multiply else torch.abs(a - b)
            outs.append(torch.sum(prod, dim=1) / sumelems)
    out = torch.stack(outs, dim=1)
    return out, torch.zeros_like(out)


# ----------------------------------------------------------------------------
# sharding constraint: the identity on one device
# ----------------------------------------------------------------------------


@register("_sharding_constraint")
def _sharding_constraint(data, sharding=None):
    """The identity on one device.  A sharding (the JAX package pins an
    intermediate's GSPMD partitioning) is slice S8 and raises."""
    if sharding is None:
        return data
    raise MXNetError("_sharding_constraint with a sharding needs the port's "
                     "meshes and placements, which come with slice S8 "
                     "(ROADMAP.md); on one device pass sharding=None")


# ----------------------------------------------------------------------------
# legacy and version aliases: the reference keeps *_v1 registrations of
# ops it later rewrote; here they are aliases of the modern ops
# ----------------------------------------------------------------------------

alias("BatchNorm_v1", "BatchNorm")
alias("Convolution_v1", "Convolution")
alias("Pooling_v1", "Pooling")
alias("CuDNNBatchNorm", "BatchNorm")
alias("_CrossDeviceCopy", "identity")
