"""Contrib operators: box IoU and NMS, FFT, the index ops, quantize and
dequantize, count sketch, the encoder-decoder attention matmuls, the
Hawkes log-likelihood and ``boolean_mask``.

The port's counterpart of the JAX package's ``ops/contrib.py``, op for
op, with its names, attributes and defaults.  ``_contrib_box_nms`` sorts
each image's boxes by score (a stable ascending sort of the negated
scores, as ``jnp.argsort(-score)``) and keeps them with O4
(``ops/box_nms.py``: the CUDA C++ kernel on the card, its plain version
on the host).  As in the JAX package, ``id_index``, ``background_id``,
``force_suppress`` and ``topk`` are accepted and unused: a box
suppresses any later box above the threshold, whatever its class, and
every kept box stays (ROADMAP.md R7).

``boolean_mask``'s output shape depends on the mask, so it reads the
mask on the host (a sync, as the JAX package's does); under a CUDA graph
capture it raises ``MXNetError``.  ``edge_id`` and ``dgl_adjacency``
take ``CSRNDArray``s and come with ``ndarray/sparse.py`` (slice S7e).
The index ops' integer outputs are int32, or int64 under
``MXNET_INT64_TENSOR_SIZE=1`` (the JAX package's x64 switch).
"""
from __future__ import annotations

import torch

from .. import graph_cache as _graph_cache
from . import box_nms as _nms
from .registry import register
from .tensor import _div, _index_dtype, _rdiv


@register("_contrib_fft")
def _fft(data, compute_size=128):
    """The FFT over the last axis, as interleaved (real, imaginary) f32
    pairs: (..., n) -> (..., 2n)."""
    out = torch.fft.fft(data.to(torch.complex64))
    return torch.stack([out.real, out.imag], dim=-1).reshape(
        data.shape[:-1] + (2 * data.shape[-1],)).to(torch.float32)


@register("_contrib_ifft")
def _ifft(data, compute_size=128):
    """The inverse of ``fft``'s layout, unnormalized (times n): the real
    part, (..., 2n) -> (..., n)."""
    c = data.reshape(data.shape[:-1] + (data.shape[-1] // 2, 2))
    comp = torch.complex(c[..., 0].float(), c[..., 1].float())
    return torch.fft.ifft(comp).real.to(torch.float32) * comp.shape[-1]


def _scatter_rows(base, idx, rows):
    """``base`` with ``rows`` written at ``idx`` along axis 0: negative
    ids count from the end, ids out of range are dropped (a spare row),
    as XLA's scatter drops them."""
    n = base.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    spare = torch.cat([base, base.new_zeros((1,) + tuple(base.shape[1:]))])
    return spare.index_copy(0, idx, rows.to(base.dtype))[:n]


@register("_contrib_index_copy")
def _index_copy(old, idx, new):
    return _scatter_rows(old, idx, new)


@register("_contrib_index_array")
def _index_array(data, axes=None):
    shape = data.shape
    if axes is None:
        axes = tuple(range(len(shape)))
    grids = torch.meshgrid(*[torch.arange(shape[a], device=data.device)
                             for a in axes], indexing="ij")
    return torch.stack(grids, dim=-1).to(_index_dtype())


@register("_contrib_getnnz")
def _getnnz(data, axis=None):
    nz = (data != 0).to(torch.int64)
    out = nz.sum() if axis is None else nz.sum(dim=axis)
    return out.to(_index_dtype())


class _GradMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("_contrib_gradientmultiplier",
          aliases=("_contrib_backward_gradientmultiplier",))
def _gradientmultiplier(data, scalar=1.0):
    """The identity whose gradient is scaled by ``scalar``."""
    return _GradMultiplier.apply(data, float(scalar))


def _to_corner(b):
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


@register("_contrib_box_iou")
def _box_iou(lhs, rhs, format="corner"):
    """IoU matrix between two box sets (..., N, 4) and (..., M, 4) ->
    (..., N, M) (parity: bounding_box.cc box_iou)."""
    if format == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    return _nms.iou(lhs[..., :, None, :], rhs[..., None, :, :])


@register("_contrib_box_nms")
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, background_id=-1,
             force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS (see the module docstring): ``(out, order)``, where
    ``out`` holds each image's rows sorted by score with suppressed rows
    set to -1, and ``order`` the sorted rows' original positions (f32)."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))        # (B, N, E)
    e = flat.shape[-1]
    order = torch.sort(-flat[:, :, score_index], dim=1, stable=True).indices
    srt = torch.gather(flat, 1, order.unsqueeze(-1).expand(-1, -1, e))
    coords = srt[:, :, coord_start:coord_start + 4]
    if in_format == "center":
        coords = _to_corner(coords)
    valid0 = srt[:, :, score_index] > valid_thresh
    keep = _nms.nms_keep(coords.detach(), valid0, overlap_thresh)
    out = torch.where(keep.unsqueeze(-1), srt, -torch.ones_like(srt))
    return out.reshape(shape), order.to(torch.float32).reshape(shape[:-1])


@register("_contrib_quantize")
def _quantize(data, min_range, max_range, out_type="uint8"):
    """Linear quantization (parity: src/operator/quantization/
    quantize.cc): ``(q, min_range, max_range)``."""
    if out_type == "uint8":
        qmin, qmax, dt = 0.0, 255.0, torch.uint8
    else:
        qmin, qmax, dt = -127.0, 127.0, torch.int8
    scale = _rdiv(qmax - qmin, (max_range - min_range).clamp_min(1e-12))
    q = torch.clamp(torch.round((data - min_range) * scale + qmin),
                    qmin, qmax)
    return q.to(dt), min_range, max_range


@register("_contrib_dequantize")
def _dequantize(data, min_range, max_range, out_type="float32"):
    if data.dtype == torch.uint8:
        qmin, qmax = 0.0, 255.0
    else:
        qmin, qmax = -127.0, 127.0
    scale = _div(max_range - min_range, qmax - qmin)
    return (data.to(torch.float32) - qmin) * scale + min_range


@register("_contrib_count_sketch")
def _count_sketch(data, h, s, out_dim=16, processing_batch_size=32):
    """Each input column added, times its sign ``s``, into output column
    ``h`` (duplicates summed)."""
    idx = h.to(torch.int64).reshape(-1)
    sign = s.reshape(-1)
    out = data.new_zeros(tuple(data.shape[:-1]) + (int(out_dim),))
    return out.index_add(data.dim() - 1, idx, data * sign)


# ----------------------------------------------------------------------------
# encoder-decoder interleaved attention matmuls (parity:
# src/operator/contrib/transformer.cc:650-780)
# ----------------------------------------------------------------------------


@register("_contrib_interleaved_matmul_encdec_qk")
def _interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """queries (Tq, B, H*D), keys_values (Tk, B, 2*H*D) -> the scaled
    ``q k^T`` (B*heads, Tq, Tk); the scale ``1 / sqrt(D)`` is formed in
    f32 and rounded to the data's dtype, as the JAX package does."""
    tq, b, _ = queries.shape
    tk = keys_values.shape[0]
    q = queries.reshape(tq, b, heads, -1)
    d = q.shape[-1]
    k = keys_values.reshape(tk, b, heads, 2, -1)[:, :, :, 0, :]
    q = q.permute(1, 2, 0, 3).reshape(b * heads, tq, d)
    k = k.permute(1, 2, 0, 3).reshape(b * heads, tk, d)
    inv = 1.0 / torch.tensor(float(d)).sqrt()                # f32
    return torch.matmul(q * inv.to(q.dtype).item(), k.transpose(-1, -2))


@register("_contrib_interleaved_matmul_encdec_valatt")
def _interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    """keys_values (Tk, B, 2*H*D), attention (B*heads, Tq, Tk) -> (Tq, B,
    H*D)."""
    tk, b, _ = keys_values.shape
    v = keys_values.reshape(tk, b, heads, 2, -1)[:, :, :, 1, :]
    d = v.shape[-1]
    v = v.permute(1, 2, 0, 3).reshape(b * heads, tk, d)
    out = torch.matmul(attention, v)
    tq = out.shape[1]
    out = out.reshape(b, heads, tq, d).permute(2, 0, 1, 3)
    return out.reshape(tq, b, heads * d)


# ----------------------------------------------------------------------------
# Hawkes process log-likelihood (parity: src/operator/contrib/hawkes_ll.cc)
# ----------------------------------------------------------------------------


@register("_contrib_hawkesll", aliases=("_contrib_backward_hawkesll",))
def _hawkesll(lda, alpha, beta, state, lags, marks, valid_length, max_time):
    """Joint log-likelihood of K univariate Hawkes processes with
    exponential decay: ``(ll (N,), new state (N, K))``, the JAX package's
    scan as a loop over the T steps, every sample at once."""
    n, t_len = lags.shape
    k = lda.shape[1]
    marks = marks.to(torch.int64)
    ks = torch.arange(k, device=lda.device)
    t = lda.new_zeros(n)
    ll = lda.new_zeros(n)
    st = state
    last = lda.new_zeros(n, k)

    def at(x, ci):
        return torch.gather(x, 1, ci[:, None])[:, 0]

    for j in range(t_len):
        valid = float(j) < valid_length
        ci = marks[:, j]
        hot = ks[None, :] == ci[:, None]
        t_new = t + lags[:, j]
        d = t_new - at(last, ci)
        b_c, a_c, mu_c, st_c = beta[ci], alpha[ci], at(lda, ci), at(st, ci)
        ed = torch.exp(-b_c * d)
        intensity = mu_c + a_c * b_c * st_c * ed
        comp = mu_c * d + a_c * st_c * (1 - ed)
        ll = ll + torch.where(valid, torch.log(intensity) - comp,
                              torch.zeros_like(ll))
        upd = valid[:, None] & hot
        st = torch.where(upd, (1 + st_c * ed)[:, None], st)
        last = torch.where(upd, t_new[:, None], last)
        t = torch.where(valid, t_new, t)
    d = max_time[:, None] - last
    ed = torch.exp(-beta * d)
    rem = lda * d + alpha * st * (1 - ed)
    return ll - rem.sum(dim=1), ed * st


# ----------------------------------------------------------------------------
# boolean_mask: its output shape depends on the data (a host read)
# ----------------------------------------------------------------------------


@register("_contrib_boolean_mask")
def _boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero
    (parity: src/operator/contrib/boolean_mask.cc); differentiable, its
    backward scatters into the kept slices.  Reads the mask on the host;
    raises ``MXNetError`` under a CUDA graph capture."""
    _graph_cache.refuse_host_read("_contrib_boolean_mask", index)
    idx = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, int(axis), idx)
