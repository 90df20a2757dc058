"""Quantized (int8) operator family.

The port's counterpart of the JAX package's ``ops/quantized_ops.py``, op
for op, with its names, attributes and defaults (parity:
``src/operator/quantization/*.cc``): ``quantize_v2``, ``requantize`` and
the ``_contrib_quantized_*`` compute ops, each taking its quantized
tensors' (min, max) range scalars after them and returning ``(out,
min_out, max_out)``, and ``_contrib_calibrate_entropy``.

The int8 x int8 -> int32 contractions run on O5 (``int8_gemm``, the fully
connected op) and O6 (``int8_conv``, the convolution) of
``ops/int8_ops.py``: the CUDA C++ kernels on the card, their exact
float64 plain versions on the host.  The convolution is NCHW / OIHW
whatever its ``layout`` attribute says, as in the JAX package; it hands
O6 the channels-last views.  The elementwise and quantize steps are
plain torch in the JAX package's f32 order of operations: every quotient
by a constant is a true f32 division (``_div``, ``_rdiv``: torch's
``c / t`` is ``reciprocal(t) * c``, and on the card a tensor over a host
scalar multiplies by the scalar's reciprocal), and ``2.0 ** 31 - 1``
is, as an f32, 2**31.  ``_contrib_calibrate_entropy`` evaluates its 64
candidate thresholds as a batch of rows, its scatter-adds as
``index_add_``.
"""
from __future__ import annotations

import torch

from . import int8_ops as _int8
from .registry import register
from .tensor import _div, _rdiv

_INT32_MAX = 2.0 ** 31 - 1      # 2**31 once it is an f32


def _absmax(lo, hi):
    return torch.maximum(lo.abs(), hi.abs())


def _ranges(min_r, max_r, dtype):
    """Symmetric-int8 / uint8 scale for a [min, max] float range."""
    if dtype == torch.uint8:
        return _rdiv(255.0, torch.clamp_min(max_r - min_r, 1e-12)), 0.0
    return _rdiv(127.0, torch.clamp_min(_absmax(min_r, max_r), 1e-12)), 0.0


@register("_contrib_quantize_v2")
def _quantize_v2(data, out_type="int8", min_calib_range=None,
                 max_calib_range=None):
    if min_calib_range is None or max_calib_range is None:
        min_r = data.min()
        max_r = data.max()
    else:
        min_r = data.new_full((), float(min_calib_range),
                              dtype=torch.float32)
        max_r = data.new_full((), float(max_calib_range),
                              dtype=torch.float32)
    if out_type == "uint8":
        scale = _rdiv(255.0, torch.clamp_min(max_r - min_r, 1e-12))
        q = torch.clamp(torch.round((data - min_r) * scale), 0, 255)
        return q.to(torch.uint8), min_r.reshape(()), max_r.reshape(())
    amax = _absmax(min_r, max_r)
    q = _int8.quantize_int8(data,
                            _rdiv(127.0, torch.clamp_min(amax, 1e-12)))
    return q, (-amax).reshape(()), amax.reshape(())


@register("_contrib_requantize")
def _requantize(data, min_range, max_range, out_type="int8",
                min_calib_range=None, max_calib_range=None):
    """int32 accumulator -> int8 with a new calibrated range."""
    in_scale = _div(_absmax(min_range, max_range), _INT32_MAX)
    f = data.to(torch.float32) * in_scale
    if min_calib_range is not None and max_calib_range is not None:
        amax = f.new_full((), max(abs(float(min_calib_range)),
                                  abs(float(max_calib_range))))
    else:
        amax = torch.clamp_min(f.abs().max(), 1e-12)
    return _int8.quantize_int8(f, _rdiv(127.0, amax)), -amax, amax


def _dequant(q, min_r, max_r):
    if q.dtype == torch.uint8:
        scale = _div(max_r - min_r, 255.0)
        return q.to(torch.float32) * scale + min_r
    return q.to(torch.float32) * _div(_absmax(min_r, max_r), 127.0)


def _int32_out_range(min_a, max_a, min_b, max_b):
    """Float range represented by the int32 accumulator of an int8×int8
    contraction (reference: quantization_utils.h
    GetQuantizedToQuantizedScale)."""
    sa = _div(_absmax(min_a, max_a), 127.0)
    sb = _div(_absmax(min_b, max_b), 127.0)
    out = sa * sb * _INT32_MAX
    return -out, out


def _int32_bias(bias, min_bias, max_bias, hi):
    """The int8 bias rescaled into the int32 accumulator's scale."""
    sb = _div(_absmax(min_bias, max_bias), 127.0)
    sacc = _div(hi, _INT32_MAX)
    return torch.round(bias.to(torch.float32) * sb / sacc).to(torch.int32)


@register("_contrib_quantized_fully_connected",
          inputs=("data", "weight", "bias", "min_data", "max_data",
                  "min_weight", "max_weight", "min_bias", "max_bias"))
def _quantized_fc(data, weight, bias=None, min_data=None, max_data=None,
                  min_weight=None, max_weight=None, min_bias=None,
                  max_bias=None, num_hidden=1, no_bias=False, flatten=True):
    """O5 on the int8 values, plus the rounded int32 bias in its
    epilogue."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    lo, hi = _int32_out_range(min_data, max_data, min_weight, max_weight)
    b32 = _int32_bias(bias, min_bias, max_bias, hi) \
        if bias is not None and not no_bias else None
    xq = x.to(torch.int8)
    acc = _int8.int8_gemm(xq.reshape(-1, xq.shape[-1]),
                          weight.to(torch.int8), bias=b32)
    return acc.reshape(tuple(xq.shape[:-1]) + (acc.shape[-1],)), lo, hi


@register("_contrib_quantized_conv",
          inputs=("data", "weight", "bias", "min_data", "max_data",
                  "min_weight", "max_weight", "min_bias", "max_bias"))
def _quantized_conv(data, weight, bias=None, min_data=None, max_data=None,
                    min_weight=None, max_weight=None, min_bias=None,
                    max_bias=None, kernel=(1, 1),
                    stride=(1, 1), dilate=(1, 1), pad=(0, 0), num_filter=1,
                    num_group=1, no_bias=False, layout="NCHW"):
    """O6 on NCHW data and an OIHW weight (whatever ``layout`` says),
    through their channels-last views, plus the rounded int32 bias."""
    sh = tuple(int(s) for s in stride) if stride else (1, 1)
    dl = tuple(int(d) for d in dilate) if dilate else (1, 1)
    pd = tuple(int(p) for p in pad) if pad else (0, 0)
    lo, hi = _int32_out_range(min_data, max_data, min_weight, max_weight)
    b32 = _int32_bias(bias, min_bias, max_bias, hi) \
        if bias is not None and not no_bias else None
    acc = _int8.int8_conv(data.to(torch.int8).permute(0, 2, 3, 1),
                          weight.to(torch.int8).permute(0, 2, 3, 1), sh, pd,
                          dl, int(num_group), bias=b32)
    return acc.permute(0, 3, 1, 2), lo, hi


@register("_contrib_quantized_pooling")
def _quantized_pooling(data, min_data, max_data, kernel=(1, 1),
                       stride=(1, 1), pad=(0, 0), pool_type="max",
                       global_pool=False, pooling_convention="valid"):
    from .nn import _pooling

    # max/avg pooling commutes with the affine dequantization, so pool the
    # int values directly (avg in f32 then round back)
    out = _pooling(data.to(torch.int32).to(torch.float32), kernel=kernel,
                   stride=stride, pad=pad, pool_type=pool_type,
                   global_pool=global_pool,
                   pooling_convention=pooling_convention)
    return torch.round(out).to(data.dtype), min_data, max_data


@register("_contrib_quantized_act")
def _quantized_act(data, min_data, max_data, act_type="relu"):
    if act_type != "relu":
        # as the JAX package and the reference: relu only
        # (src/operator/quantization/quantized_activation.cc:54,110)
        raise NotImplementedError(
            "quantized act: only relu (same as the reference, "
            "quantized_activation.cc:110)")
    out = torch.maximum(data, torch.zeros((), dtype=data.dtype,
                                          device=data.device))
    return out, torch.clamp_min(min_data, 0.0), max_data


@register("_contrib_quantized_flatten")
def _quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_elemwise_add")
def _quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    f = _dequant(lhs, lhs_min, lhs_max) + _dequant(rhs, rhs_min, rhs_max)
    amax = torch.clamp_min(f.abs().max(), 1e-12)
    return _int8.quantize_int8(f, _rdiv(127.0, amax)), -amax, amax


@register("_contrib_quantized_elemwise_mul")
def _quantized_elemwise_mul(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    acc = lhs.to(torch.int32) * rhs.to(torch.int32)
    lo, hi = _int32_out_range(lhs_min, lhs_max, rhs_min, rhs_max)
    return acc, lo, hi


@register("_contrib_quantized_concat")
def _quantized_concat(*arrays, num_args=1, dim=1):
    # input layout: [data_0..data_{n-1}, min_0..min_{n-1}, max_0..max_{n-1}]
    n = len(arrays) // 3
    qs, mins, maxs = arrays[:n], arrays[n:2 * n], arrays[2 * n:]
    # requantize every input to the widest range, then concat
    amax = mins[0] * 0.0
    for lo, hi in zip(mins, maxs):
        amax = torch.maximum(amax, _absmax(lo, hi))
    scale = _rdiv(127.0, amax)
    outs = [_int8.quantize_int8(_dequant(q, lo, hi), scale)
            for q, lo, hi in zip(qs, mins, maxs)]
    return torch.cat(outs, dim=int(dim)), -amax, amax


@register("_contrib_quantized_embedding")
def _quantized_embedding(data, weight, min_weight, max_weight,
                         input_dim=1, output_dim=1, dtype="float32"):
    """Rows of the int8 table; ids are truncated to integers and clipped
    into range, as ``jnp.take(mode="clip")`` does."""
    ids = data.to(torch.int32).long().clamp(0, max(weight.shape[0] - 1, 0))
    out = torch.index_select(weight, 0, ids.reshape(-1))
    return (out.reshape(tuple(ids.shape) + tuple(weight.shape[1:])),
            min_weight, max_weight)


@register("_contrib_quantized_batch_norm",
          inputs=("data", "gamma", "beta", "moving_mean", "moving_var",
                  "min_data", "max_data"))
def _quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                          min_data, max_data, eps=1e-3, momentum=0.9,
                          fix_gamma=True, use_global_stats=False,
                          axis=1, min_calib_range=None,
                          max_calib_range=None):
    f = _dequant(data, min_data, max_data)
    g = torch.ones_like(moving_mean) if fix_gamma else gamma
    shape = [1] * f.dim()
    shape[axis] = -1
    out = ((f - moving_mean.reshape(shape))
           * (g / torch.sqrt(moving_var + eps)).reshape(shape)
           + beta.reshape(shape))
    if min_calib_range is not None:
        amax = out.new_full((), max(abs(float(min_calib_range)),
                                    abs(float(max_calib_range))))
    else:
        amax = torch.clamp_min(out.abs().max(), 1e-12)
    return _int8.quantize_int8(out, _rdiv(127.0, amax)), -amax, amax


_ENTROPY_CANDIDATES = 64


@register("_contrib_calibrate_entropy")
def _calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """KL-entropy calibration threshold from a histogram (reference:
    quantization/calibrate.cc).  Returns (min, max) of the optimal range.

    As in the JAX package, the KL divergence is evaluated for a fixed
    grid of 64 candidate thresholds (``amax * (i + 1) / 64``): here as 64
    rows at once, the quantized bins' sums and counts scatter-added with
    ``index_add_``."""
    nc = _ENTROPY_CANDIDATES
    centers = _div(hist_edges[:-1] + hist_edges[1:], 2.0)
    amax = hist_edges.abs().max()
    nq = int(num_quantized_bins)
    fracs = _div(torch.arange(nc, dtype=torch.float32,
                              device=hist.device) + 1.0, float(nc))
    th = (amax * fracs)[:, None]                           # (nc, 1)
    absc = centers.abs()[None, :]                          # (1, nbins)
    w = absc <= th                                         # (nc, nbins)
    wf = w.to(torch.float32)
    p = torch.where(w, hist, 0.0)
    outliers = torch.where(w, 0.0, hist).sum(1, keepdim=True)
    # assign outliers to the edge bins like the reference
    p = p + outliers / torch.clamp_min(wf.sum(1, keepdim=True), 1.0)
    # quantize p into nq bins then expand back
    bin_idx = torch.clamp((absc / torch.clamp_min(th, 1e-12)
                           * (nq / 2)).to(torch.int32), 0, nq - 1).long()
    flat = (bin_idx + torch.arange(nc, device=hist.device)[:, None] * nq) \
        .reshape(-1)
    q_sums = torch.zeros(nc * nq, dtype=p.dtype, device=hist.device) \
        .index_add_(0, flat, torch.where(w, p, 0.0).reshape(-1)) \
        .reshape(nc, nq)
    q_cnts = torch.zeros(nc * nq, dtype=torch.float32, device=hist.device) \
        .index_add_(0, flat, wf.reshape(-1)).reshape(nc, nq)
    q = torch.where(w, torch.gather(q_sums, 1, bin_idx)
                    / torch.clamp_min(torch.gather(q_cnts, 1, bin_idx), 1.0),
                    0.0)
    pn = p / torch.clamp_min(p.sum(1, keepdim=True), 1e-12)
    qn = q / torch.clamp_min(q.sum(1, keepdim=True), 1e-12)
    kls = torch.where((pn > 0) & (qn > 0),
                      pn * torch.log(pn / torch.clamp_min(qn, 1e-12)),
                      0.0).sum(1)
    best = fracs[torch.argmin(kls)] * amax
    return -best, best
